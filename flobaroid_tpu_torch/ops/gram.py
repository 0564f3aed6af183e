"""Gram contraction G = Y^T Y — the identification hot op.

Counterpart of flobaroid_tpu/ops/gram.py. On a CUDA tensor the work runs
in the hand-written Hopper kernel `csrc/gram.cu` (which replaces the
Pallas `_gram_kernel`); on a CPU tensor it runs in the plain PyTorch
version `gram_plain`. There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

`gram_batched` is the form the main path uses: Y (N, B, C) gives the B
Grams (B, C, C) in one launch — the per-channel Grams of the streamed
identification (B = output channels, τ and the contact column appended
to C), and the structural Gram with B = 1.
"""

from __future__ import annotations

import ctypes

import torch

# Number of kernel launches made by gram_batched (incremented only where
# the kernel is launched; callers reset it to observe one run).
launches = 0

_TILE = 32
_MAX_CHAIN = 2048  # rows summed sequentially by one thread (f32 sum chain)
_MIN_CHAIN = 128  # fewest rows a row split is worth


def gram_plain(Y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: G[b] = Y[:, b]^T Y[:, b] in Y's dtype."""
    if Y.dim() != 3:
        raise ValueError(f"Y must be (N, B, C), got shape {tuple(Y.shape)}")
    return torch.einsum("nbp,nbq->bpq", Y, Y)


def _row_splits(N: int, B: int, C: int, sms: int) -> tuple[int, int]:
    """(rows per split, number of splits) for a card with `sms` SMs:
    enough blocks to fill every SM a few times over, and no thread
    summing more than _MAX_CHAIN rows."""
    nt = -(-C // _TILE)
    tiles = nt * (nt + 1) // 2 * B
    want = max(1, -(-4 * sms // tiles))
    S = max(-(-N // _MAX_CHAIN), min(want, -(-N // _MIN_CHAIN)), 1)
    rows = -(-N // S)
    rows = -(-rows // _TILE) * _TILE
    return rows, -(-N // rows)


def _lib():
    from ._build import load_library

    lib = load_library("gram")
    fn = lib.gram_batched_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def gram_batched(Y: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """G[b] = Y[:, b, :]^T Y[:, b, :] for Y of shape (N, B, C).

    CPU tensor: the plain version, in Y's dtype. CUDA tensor: the f32
    kernel, launched on the current stream without synchronising; Y may
    have any non-negative strides (no copy is made). Raises on anything
    the kernel does not take and on a failed build or launch."""
    global launches
    if Y.dim() != 3:
        raise ValueError(f"Y must be (N, B, C), got shape {tuple(Y.shape)}")
    if not Y.is_floating_point():
        raise TypeError(f"Y must be a floating tensor, got {Y.dtype}")
    N, B, C = Y.shape
    if Y.device.type == "cpu":
        G = gram_plain(Y)
        if out is not None:
            out.copy_(G)
            return out
        return G
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if Y.dtype != torch.float32:
        raise TypeError(f"the CUDA Gram kernel takes float32, got {Y.dtype}")
    if B < 1 or C < 1:
        raise ValueError(f"empty Gram: B={B}, C={C}")
    if min(Y.stride()) < 0:
        raise ValueError(f"negative strides are not supported: {Y.stride()}")
    if out is None:
        out = torch.empty((B, C, C), dtype=torch.float32, device=Y.device)
    elif (out.shape != (B, C, C) or out.dtype != torch.float32
          or out.device != Y.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 (B, C, C) tensor on Y's device")
    if N == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(Y.device).multi_processor_count
    rows, S = _row_splits(N, B, C, sms)
    nt = -(-C // _TILE)
    ws = torch.empty((S, B, nt * (nt + 1) // 2, _TILE, _TILE),
                     dtype=torch.float32, device=Y.device)
    fn = _lib()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        sN, sB, sC = Y.stride()
        err = fn(Y.data_ptr(), N, B, C, sN, sB, sC, rows, S,
                 ws.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# ----------------------------------------------------------------------
# public API of the JAX module, without its TPU-only options (row tile,
# interpret mode, method): there is one computation per device here
# ----------------------------------------------------------------------
def gram(Y: torch.Tensor) -> torch.Tensor:
    """G = Y^T Y, (P, P) float32: the kernel on CUDA, the plain version
    on CPU."""
    Y32 = Y.to(torch.float32)
    return gram_batched(Y32[:, None, :])[0]


def gram_xla(Y: torch.Tensor) -> torch.Tensor:
    """Plain full-precision f32 reference (the JAX module's XLA path)."""
    Y32 = Y.to(torch.float32)
    return gram_plain(Y32[:, None, :])[0]


def gram_augmented(Y: torch.Tensor, tau: torch.Tensor):
    """(Y^T Y, Y^T tau, tau^T tau) in one pass by appending tau as a
    column."""
    aug = torch.cat([Y, tau[:, None]], dim=1)
    G = gram(aug)
    P = Y.shape[1]
    return G[:P, :P], G[:P, P], G[P, P]
