"""The check that a run has loaded neither JAX nor the JAX package.

Names are compared by their top-level part (before the first dot) as a
whole word: ``cwipc_util_tpu_torch``, the port, is not
``cwipc_util_tpu``, the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cwipc_util_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names if name.split(".", 1)[0] in FORBIDDEN)
