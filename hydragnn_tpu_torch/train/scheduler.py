"""Learning-rate plateau, early stopping and the best checkpoint (port of
``train/scheduler.py``), each with the ``state_dict`` that goes into a
checkpoint's ``train_meta``.

``ReduceLROnPlateau`` has ``torch.optim.lr_scheduler.ReduceLROnPlateau``'s
rule (mode min, factor 0.5, patience 5, relative threshold 1e-4, min_lr
1e-5) on a host float, which the epoch driver writes into the optimizer's
param groups; ``EarlyStopping`` stops after ``patience`` epochs without a
lower validation loss; ``BestCheckpoint`` saves from epoch ``warmup`` on
whenever the validation loss is the lowest so far.
"""


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.00001,
    ):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, metric):
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric) -> float:
        """Feed the epoch's validation loss; returns the (possibly reduced)
        learning rate."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        """The counters only (the hyperparameters come from the resuming
        run's config), so that a resumed run keeps the plateau history."""
        return {
            "lr": float(self.lr),
            "best": None if self.best is None else float(self.best),
            "num_bad_epochs": int(self.num_bad_epochs),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.lr = float(sd["lr"])
        best = sd.get("best")
        self.best = None if best is None else float(best)
        self.num_bad_epochs = int(sd["num_bad_epochs"])


class EarlyStopping:
    """Stop when the validation loss has not improved for ``patience``
    epochs."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.counter = 0
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best is None or val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    def state_dict(self) -> dict:
        return {
            "best": None if self.best is None else float(self.best),
            "counter": int(self.counter),
            "early_stop": bool(self.early_stop),
        }

    def load_state_dict(self, sd: dict) -> None:
        best = sd.get("best")
        self.best = None if best is None else float(best)
        self.counter = int(sd["counter"])
        self.early_stop = bool(sd["early_stop"])


class BestCheckpoint:
    """Save on the best validation loss, after ``warmup`` epochs."""

    def __init__(self, name: str, warmup: int = 10, path: str = "./logs/"):
        self.name = name
        self.warmup = warmup
        self.path = path
        self.best = None

    def __call__(self, state_dict, epoch: int, val_loss: float, save_fn) -> bool:
        if epoch < self.warmup:
            return False
        if self.best is None or val_loss < self.best:
            self.best = val_loss
            save_fn(state_dict, self.name, self.path)
            return True
        return False

    def state_dict(self) -> dict:
        return {"best": None if self.best is None else float(self.best)}

    def load_state_dict(self, sd: dict) -> None:
        best = sd.get("best")
        self.best = None if best is None else float(best)
