"""Early stopping (``betty_tpu/misc/early_stopping.py``), with the
reference's ``patience``/``tolerance`` crash fixed as there."""

from betty_tpu_torch.utils import convert_scalar


class EarlyStopping:
    def __init__(self, metric: str = "loss", mode: str = "min", tolerance: int = 5):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.tolerance = tolerance
        self.best = None
        self.counter = 0

    def __call__(self, validation_stats) -> bool:
        assert self.metric in validation_stats, (
            f"early-stopping metric {self.metric!r} not in validation stats")
        value = convert_scalar(validation_stats[self.metric])
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best)
                    or (self.mode == "max" and value > self.best))
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.tolerance
