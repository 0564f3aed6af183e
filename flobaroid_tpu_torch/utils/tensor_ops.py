"""Small tensor helpers whose subgradients follow the JAX package's.

`jnp.clip`, `jnp.maximum` and `jnp.minimum` split the gradient evenly at
a tie; `torch.clamp` sends all of it through. The optimizer's chain is
held against `jax.grad`, so the port clips with `torch.maximum` /
`torch.minimum` (which split like JAX) against constants cached per
(value, dtype, device), so that no call makes a host-to-device copy of
its own.
"""

from __future__ import annotations

import torch

_CONSTS: dict = {}


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """0-d tensor of `value` with the dtype and device of `like`."""
    key = (float(value), like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(float(value), dtype=like.dtype, device=like.device)
    return c


def _t(v, like):
    return v if isinstance(v, torch.Tensor) else const(v, like)


def maximum(x, v):
    return torch.maximum(x, _t(v, x))


def minimum(x, v):
    return torch.minimum(x, _t(v, x))


def clip(x, lo, hi):
    """min(max(x, lo), hi), the composition `jnp.clip` differentiates."""
    return torch.minimum(torch.maximum(x, _t(lo, x)), _t(hi, x))
