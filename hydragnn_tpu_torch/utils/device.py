"""Device choice for the port's entry points.

The port runs on one NVIDIA H100. Its entry points (``create_model_config``,
``InferenceServer``) take ``device=None`` to mean the card; the CPU runs
only when a caller asks for it by name, as the CPU tests do. There is no
quiet fallback: a missing card is an error, not a slower run.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` for ``None``; ``cpu`` only when asked for.

    Raises ``RuntimeError`` when ``cuda`` is wanted (explicitly or by
    default) and ``torch.cuda.is_available()`` is false, and
    ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"device {dev} is not supported: the port runs on 'cuda', or on "
            "'cpu' when asked for by name"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
