"""``run_training(config_or_path, device=None, telemetry_port=None)``: train
the run a config describes (a dict, or the path of a JSON file) and keep its
checkpoint under ``./logs/<run name>/`` (``train/driver.py``). On the card
unless ``device="cpu"``.

Every run records its telemetry under ``./logs/<run name>/``: the event
stream ``events.jsonl``, the per-epoch scalars, and, when a port is asked
for, a live ``/metrics`` + ``/healthz`` + ``/profile`` endpoint for the
run's duration. ``telemetry_port`` asks for one as ``HYDRAGNN_OBS_PORT``
does (and beats it and ``config["Telemetry"]["port"]``); 0 binds an
ephemeral port. ``HYDRAGNN_TELEMETRY=0`` disables the events, the metrics
and the endpoint (the scalar files stay).
"""

import json


def run_training(config, device=None, use_devices=None, telemetry_port=None):
    if use_devices is not None:
        raise TypeError(
            "run_training(use_devices=...) is deprecated and was never honored; remove "
            "the argument and pass device=None (the card) or device='cpu'"
        )
    if isinstance(config, str):
        with open(config, "r") as f:
            config = json.load(f)
    from hydragnn_tpu_torch.train.driver import run_training_impl

    return run_training_impl(config, device=device,
                             telemetry_port=None if telemetry_port is None else int(telemetry_port))
