"""The check that no module of JAX or of the JAX package is loaded: each
module's top-level name (the part before the first dot) compared whole,
since the port's name, planet_tpu_torch, begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "planet_tpu"})


def loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
