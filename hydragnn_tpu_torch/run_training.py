"""``run_training(config_or_path, device=None)``: train the run a config
describes (a dict, or the path of a JSON file) and keep its checkpoint
under ``./logs/<run name>/`` (``train/driver.py``). On the card unless
``device="cpu"``."""

import json


def run_training(config, device=None, use_devices=None, telemetry_port=None):
    if use_devices is not None:
        raise TypeError(
            "run_training(use_devices=...) is deprecated and was never honored; remove "
            "the argument and pass device=None (the card) or device='cpu'"
        )
    if telemetry_port is not None:
        raise NotImplementedError(
            "telemetry_port (the live /metrics endpoint) is not ported yet: see "
            "ROADMAP.md, queue 1, item 10")
    if isinstance(config, str):
        with open(config, "r") as f:
            config = json.load(f)
    if (config.get("Telemetry") or {}).get("port") is not None:
        raise NotImplementedError(
            "Telemetry.port (the live /metrics endpoint) is not ported yet: see "
            "ROADMAP.md, queue 1, item 10")
    from hydragnn_tpu_torch.train.driver import run_training_impl

    return run_training_impl(config, device=device)
