"""Device and precision policy.

Counterpart of the JAX engine's `_full_precision` (flobaroid_tpu/
dynamics/engine.py): a reduced-precision f32 matmul costs ~3 decimal
digits on the regressor/RNEA identity, so TF32 is switched off for
matmuls and convolutions and the f32 matmul precision is "highest".
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def apply_precision_policy() -> None:
    """Full-f32 matmuls everywhere (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """The device of a computation (the entry points default to "cuda").
    None is an error, and "cuda" without a card is one too: there is no
    CPU fallback."""
    if device is None:
        raise ValueError("an explicit device is required ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    apply_precision_policy()
    return dev


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a `computeDtype` option string."""
    key = str(name).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"unsupported computeDtype {name!r} (float32 or float64)")
    return _DTYPES[key]
