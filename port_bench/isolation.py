"""The check that nothing a run loaded is JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, whole: `pathtracer_tpu_torch` (the port) begins with `pathtracer_tpu`
(the JAX package) and is not it.
"""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pathtracer_tpu"})


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name is one of `forbidden`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in forbidden)
