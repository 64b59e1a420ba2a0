"""The check that the timed process ran without JAX or the JAX package.

Names are compared by their top-level part (before the first dot),
whole: ``production_stack_tpu_torch`` is the program,
``production_stack_tpu`` the JAX package it was ported from.
"""

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "production_stack_tpu")


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level packages among ``names`` (by default the
    modules this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))
