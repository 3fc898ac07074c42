"""Logging (``betty_tpu/logging``): stdout only in this slice; the
TensorBoard and W&B sinks are not ported, and asking for them logs a
warning and falls back to stdout."""

from betty_tpu_torch.logging.logger_base import LoggerBase, get_logger


def logger(logger_type: str = "none") -> LoggerBase:
    if logger_type not in ("none", "stdout"):
        get_logger().warning(f"logger_type={logger_type!r} is not ported; logging to stdout")
    return LoggerBase()


__all__ = ["LoggerBase", "get_logger", "logger"]
