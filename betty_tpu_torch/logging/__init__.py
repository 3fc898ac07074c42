"""Logging sinks (``betty_tpu/logging``): a stdlib logger that prints to
stdout, and the TensorBoard and Weights & Biases sinks chosen by
``EngineConfig.logger_type`` (``"tensorboard"`` or ``"tb"``, ``"wandb"``).
A sink whose package is not installed logs a warning and falls back to
stdout, as the JAX package's factory does."""

from betty_tpu_torch.logging.logger_base import LoggerBase, get_logger


def logger(logger_type: str = "none") -> LoggerBase:
    if logger_type in ("tensorboard", "tb"):
        try:
            from betty_tpu_torch.logging.logger_tensorboard import TensorBoardLogger

            return TensorBoardLogger()
        except ImportError:
            get_logger().warning("tensorboard is not installed; falling back to stdout logging")
            return LoggerBase()
    if logger_type == "wandb":
        try:
            from betty_tpu_torch.logging.logger_wandb import WandBLogger

            return WandBLogger()
        except ImportError:
            get_logger().warning("wandb is not installed; falling back to stdout logging")
            return LoggerBase()
    return LoggerBase()


__all__ = ["LoggerBase", "get_logger", "logger"]
