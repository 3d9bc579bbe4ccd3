"""The port's timing helpers, on the CPU.

``time_ms``, ``call_ms`` and ``device_ms`` measure only a card: on the CPU they run the
function (warm-up) and return ``None``, never a CPU time under a device
metric's name.
"""

import torch

from hydragnn_tpu_torch.utils.timing import call_ms, device_ms, time_ms


def pytest_timing_returns_none_on_cpu():
    calls = []
    cpu = torch.device("cpu")
    assert time_ms(lambda: calls.append(1), cpu) is None
    assert device_ms(lambda: calls.append(1), cpu) is None
    assert len(calls) == 3  # time_ms's warm-up; device_ms runs nothing



def pytest_call_ms_takes_turns_and_returns_none_on_cpu():
    order = []
    fns = [lambda: order.append("a"), lambda: order.append("b")]
    assert call_ms(fns, torch.device("cpu"), repeats=2) == [None, None]
    assert order == ["a"] * 3 + ["b"] * 3 + ["a"] * 3 + ["b"] * 3
