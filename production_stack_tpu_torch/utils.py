"""Logging and device resolution shared by the port's modules."""

import logging
import os
import sys

import torch

_COLORS = {
    logging.DEBUG: "\x1b[38;20m",
    logging.INFO: "\x1b[36;20m",
    logging.WARNING: "\x1b[33;20m",
    logging.ERROR: "\x1b[31;20m",
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"
_FMT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"


class ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__(_FMT, datefmt="%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def init_logger(name: str, level: str | int | None = None) -> logging.Logger:
    """Create/fetch a logger with the stack's formatter attached once
    (level from PSTPU_LOG_LEVEL, as in the JAX package)."""
    logger = logging.getLogger(name)
    if level is None:
        level = os.environ.get("PSTPU_LOG_LEVEL", "INFO")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    logger.setLevel(level)
    if not any(isinstance(h.formatter, ColorFormatter)
               for h in logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter(use_color=sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device on a machine
    without CUDA raises: the port never drops to the CPU on its own —
    the caller asks for ``"cpu"`` explicitly (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} "
                         f"(cuda or cpu)")
    return dev
