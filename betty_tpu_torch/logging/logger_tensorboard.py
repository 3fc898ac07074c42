"""TensorBoard sink (``betty_tpu/logging/logger_tensorboard.py``).

Writes scalars through ``torch.utils.tensorboard.SummaryWriter``, which
needs the ``tensorboard`` package: importing this module raises
``ImportError`` without it, and the ``logger`` factory then falls back to
stdout. The log directory defaults to the JAX package's
``betty_tensorboard/<time>_<host>`` under the working directory at
construction; a metric
``key`` of problem ``tag`` is written as ``"{tag}/{key}"``.
"""

import atexit
import os
import socket
import time

from torch.utils.tensorboard import SummaryWriter

from betty_tpu_torch.logging.logger_base import LoggerBase
from betty_tpu_torch.utils import convert_scalar


class TensorBoardLogger(LoggerBase):
    def __init__(self, log_dir=None):
        if log_dir is None:
            now = time.strftime("%Y%m%d-%H%M%S")
            log_dir = os.path.join("betty_tensorboard", f"{now}_{socket.gethostname()}")
        # absolute: the writer's thread opens its file later, whatever the
        # working directory is then
        self.writer = SummaryWriter(log_dir=os.path.abspath(log_dir))
        atexit.register(self.writer.close)

    def log(self, stats, tag=None, step=None):
        if stats is None:
            return
        for key, value in stats.items():
            prefix = f"{tag}/" if tag else ""
            value = convert_scalar(value)
            if isinstance(value, (int, float)):
                self.writer.add_scalar(f"{prefix}{key}", value, step)
