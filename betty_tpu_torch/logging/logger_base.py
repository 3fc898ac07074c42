"""Stdout logger base (``betty_tpu/logging/logger_base.py``)."""

import logging
import sys

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        log = logging.getLogger("betty_tpu_torch")
        log.setLevel(logging.INFO)
        if not log.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter("[%(asctime)s] [Betty-Torch] %(message)s",
                                                   datefmt="%Y-%m-%d %H:%M:%S"))
            log.addHandler(handler)
        log.propagate = False
        _LOGGER = log
    return _LOGGER


class LoggerBase:
    """Prints to stdout; ``log`` (the structured metric sink) is a no-op."""

    def log(self, stats, tag=None, step=None):
        pass

    def debug(self, msg):
        get_logger().debug(msg)

    def info(self, msg):
        get_logger().info(msg)

    def warning(self, msg):
        get_logger().warning(msg)

    def error(self, msg):
        get_logger().error(msg)
