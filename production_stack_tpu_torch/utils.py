"""Logging, device resolution and the router's helpers (singleton
metaclass, URL validation, ulimit, static list parsers: a copy of
``production_stack_tpu/utils/misc.py`` without its JAX platform pin)
shared by the port's modules."""

import logging
import os
import re
import resource
import sys
from abc import ABCMeta
from typing import Any, Dict, List, Optional

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


class SingletonMeta(type):
    """Metaclass giving each class a single process-wide instance.

    Unlike a naive implementation, instances can be explicitly dropped
    (``Cls.reset_instance()``) so dynamic reconfiguration and tests can
    rebuild singletons without process restarts.
    """

    _instances: Dict[type, Any] = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    def instance_or_none(cls) -> Optional[Any]:
        return cls._instances.get(cls)

    def has_instance(cls) -> bool:
        return cls in cls._instances

    def reset_instance(cls) -> None:
        cls._instances.pop(cls, None)


class SingletonABCMeta(ABCMeta, SingletonMeta):
    """Singleton + ABC combined (for abstract service-discovery bases)."""


_URL_RE = re.compile(r"^(https?)://([\w.-]+)(:\d+)?(/.*)?$")


def validate_url(url: str) -> bool:
    return bool(_URL_RE.match(url))


def set_ulimit(target_soft: int = 65535) -> None:
    """Raise RLIMIT_NOFILE soft limit for high-concurrency streaming."""
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < target_soft:
            resource.setrlimit(
                resource.RLIMIT_NOFILE, (min(target_soft, hard), hard)
            )
    except (ValueError, OSError) as e:
        init_logger(__name__).warning("could not raise RLIMIT_NOFILE: %s",
                                      e)


def parse_comma_separated(value: Optional[str]) -> List[str]:
    if not value:
        return []
    return [v.strip() for v in value.split(",") if v.strip()]


def parse_static_urls(static_backends: str) -> List[str]:
    urls = parse_comma_separated(static_backends)
    bad = [u for u in urls if not validate_url(u)]
    if bad:
        raise ValueError(f"invalid backend URLs: {bad}")
    return urls


def parse_static_model_types(value: Optional[str]) -> List[str]:
    return parse_comma_separated(value)


def parse_static_aliases(value: Optional[str]) -> Dict[str, str]:
    """Parse "alias1:model1,alias2:model2" into a dict."""
    aliases: Dict[str, str] = {}
    for pair in parse_comma_separated(value):
        if ":" not in pair:
            raise ValueError(f"invalid alias spec {pair!r}, expected alias:model")
        alias, model = pair.split(":", 1)
        aliases[alias.strip()] = model.strip()
    return aliases
