"""The check that the run never loaded JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "interpolate_antialiasing_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole:
    ``interpolate_antialiasing_tpu_torch`` is not
    ``interpolate_antialiasing_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
