"""The port's version: a copy of ``production_stack_tpu/version.py``,
served on ``/version``."""

__version__ = "0.1.0"
