"""``run_prediction(config_or_path, device=None)``: load the checkpoint of
the run a config describes and predict its test split; returns ``(error,
per-head errors, true values, predicted values)`` (``train/driver.py``).
On the card unless ``device="cpu"``."""

import json


def run_prediction(config, device=None, use_devices=None):
    if use_devices is not None:
        raise TypeError(
            "run_prediction(use_devices=...) is deprecated and was never honored; remove "
            "the argument and pass device=None (the card) or device='cpu'"
        )
    if isinstance(config, str):
        with open(config, "r") as f:
            config = json.load(f)
    from hydragnn_tpu_torch.train.driver import run_prediction_impl

    return run_prediction_impl(config, device=device)
