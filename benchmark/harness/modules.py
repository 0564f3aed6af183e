"""The check that the process loaded neither JAX nor the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "flobaroid_tpu")


def forbidden_loaded(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN: `flobaroid_tpu_torch.x` passes, `flobaroid_tpu.x` not."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
