"""Weights & Biases sink (``betty_tpu/logging/logger_wandb.py``).

Importing this module raises ``ImportError`` without the ``wandb`` package,
and the ``logger`` factory then falls back to stdout. A run is started
(project ``betty_tpu`` unless given) only if none is active; every metric
``key`` of problem ``tag`` goes into one ``wandb.log`` payload as
``"{tag}/{key}"``.
"""

import wandb

from betty_tpu_torch.logging.logger_base import LoggerBase
from betty_tpu_torch.utils import convert_scalar


class WandBLogger(LoggerBase):
    def __init__(self, project=None, **kwargs):
        if wandb.run is None:
            wandb.init(project=project or "betty_tpu", **kwargs)

    def log(self, stats, tag=None, step=None):
        if stats is None:
            return
        payload = {}
        for key, value in stats.items():
            prefix = f"{tag}/" if tag else ""
            payload[f"{prefix}{key}"] = convert_scalar(value)
        wandb.log(payload, step=step)
