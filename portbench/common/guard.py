"""The check that no process of the benchmark holds JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``cannoles_tpu_torch``, the program, begins with
``cannoles_tpu``, the JAX package, and is not it.
"""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cannoles_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
