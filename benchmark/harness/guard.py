"""The import guard: the run that prints a result must not have loaded JAX,
flax or the JAX package.  Names are compared by their top-level part (the
text before the first dot), whole: ``instancefusion_tpu_torch`` is the
program, ``instancefusion_tpu`` the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "instancefusion_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (default: ``sys.modules``) whose top-level name is
    forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
