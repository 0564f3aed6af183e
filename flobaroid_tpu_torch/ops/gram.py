"""Gram contraction G = Y^T Y — the identification hot op.

Counterpart of flobaroid_tpu/ops/gram.py. On a CUDA tensor the work runs
in the hand-written Hopper kernel `csrc/gram.cu` (split-TF32 wgmma fed by
TMA, which replaces the Pallas `_gram_kernel`); on a CPU tensor it runs
in the plain PyTorch version `gram_plain`. There is no fallback between
the two: a CUDA tensor launches the kernel or raises.

`gram_batched` is the form the main path uses: Y (N, B, C) gives the B
Grams (B, C, C) in one launch — the per-channel Grams of the streamed
identification (B = output channels, τ and the contact column appended
to C), and the structural Gram with B = 1. The kernel reads Y through a
TMA tensor map, which needs 16-byte row and channel strides: the Gram
sites build Y with `cat_padded`, and the wrapper copies any other layout
into such a buffer first.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

# Number of kernel launches made by gram_batched, and their (N, B, C)
# shapes (both updated only where the kernel is launched; callers reset
# them to observe one run).
launches = 0
launch_shapes: collections.Counter = collections.Counter()

_BK = 32  # rows of Y per pipeline step of the kernel
_MAX_ROWS = 8192  # most rows one block sums before the f64 reduction
_MIN_ROWS = 256  # fewest rows a row split is worth
_BLOCK_COST = 8  # a block's fixed cost (pipeline fill, epilogue), in BK-row steps
_SPLIT_COST = 0.5  # the last block's f64 sum of one more partial tile, in BK-row steps


def gram_plain(Y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: G[b] = Y[:, b]^T Y[:, b] in Y's dtype."""
    if Y.dim() != 3:
        raise ValueError(f"Y must be (N, B, C), got shape {tuple(Y.shape)}")
    return torch.einsum("nbp,nbq->bpq", Y, Y)


def cat_padded(parts: list[torch.Tensor]) -> torch.Tensor:
    """torch.cat(parts, dim=-1) built in a buffer whose rows are padded
    with zero columns to a multiple of 4 elements, returned as the
    unpadded view: for f32, the 16-byte strides the kernel's TMA reads
    without a copy. A single part that needs no padding is returned as
    it is."""
    C = sum(p.shape[-1] for p in parts)
    pad = -C % 4
    if pad == 0 and len(parts) == 1:
        return parts[0]
    if pad:
        parts = [*parts, parts[0].new_zeros((*parts[0].shape[:-1], pad))]
    return torch.cat(parts, dim=-1)[..., :C]


class Plan(NamedTuple):
    """Launch shape of the kernel for one (N, B, C) on a card."""

    panel: int  # columns per operand panel: C rounded up to 32, or 128 for C > 128
    pairs: bool  # C > 128: upper-triangle tiles over pairs of 128-column panels
    tiles: int  # output tiles per channel
    tile_elems: int  # f32 elements of one block's partial tile
    rows: int  # rows per split, a multiple of _BK
    splits: int  # row splits; blocks = splits * B * tiles


def _rows_per_split(N: int, S: int) -> int:
    per_split = -(-N // S)
    return -(-per_split // _BK) * _BK


def _plan_cost(N: int, B: int, tiles: int, S: int, sms: int) -> float:
    """Modelled time of S row splits, in BK-row steps of one block: the
    waves of blocks over `sms` SMs times each block's steps and fixed
    cost, plus the last block's sum over the S partial tiles."""
    waves = -(-(B * tiles * S) // sms)
    return waves * (_rows_per_split(N, S) // _BK + _BLOCK_COST) + S * _SPLIT_COST


@functools.lru_cache(maxsize=256)
def _plan(N: int, B: int, C: int, sms: int) -> Plan:
    """The row split of least `_plan_cost`, with no block summing more
    than _MAX_ROWS rows and none fewer than _MIN_ROWS unless N is; ties
    go to fewer splits."""
    if C <= 128:
        panel, pairs, tiles = 32 * -(-C // 32), False, 1
    else:
        nt = -(-C // 128)
        panel, pairs, tiles = 128, True, nt * (nt + 1) // 2
    tile_rows = 128 if pairs or panel > 64 else 64
    lo = max(1, -(-N // _MAX_ROWS))
    hi = max(lo, -(-N // _MIN_ROWS))
    S = min(range(lo, hi + 1), key=lambda S: _plan_cost(N, B, tiles, S, sms))
    rows = _rows_per_split(N, S)
    return Plan(panel, pairs, tiles, tile_rows * panel, rows, -(-N // rows))


@functools.cache
def _lib():
    from ._build import load_library

    fn = load_library("gram").gram_batched_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# per (device, stream): the kernel's per-tile arrival counters. The kernel
# leaves them zero, so launches on one stream (which run in order) share
# them; another stream gets its own.
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _tma_strides(Y: torch.Tensor) -> tuple[int, int] | None:
    """(sN, sB) in elements when the kernel's tensor map can read Y in
    place (C contiguous, 16-byte aligned base and strides), else None."""
    N, B, C = Y.shape
    sN, sB, sC = Y.stride()
    if B == 1:  # the channel stride is never stepped
        sB = sN
    ok = ((sC == 1 or C == 1) and Y.data_ptr() % 16 == 0
          and all(s > 0 and s % 4 == 0 for s in (sN, sB)))
    return (sN, sB) if ok else None


def gram_batched(Y: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """G[b] = Y[:, b, :]^T Y[:, b, :] for Y of shape (N, B, C).

    CPU tensor: the plain version, in Y's dtype. CUDA tensor: the f32
    kernel, one launch on the current stream without synchronising; Y is
    read in place when its row and channel strides are multiples of 4
    elements (`cat_padded` builds such a Y), else copied into a padded
    buffer first. Raises on anything the kernel does not take and on a
    failed build or launch."""
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
    if N >= 2**31 or B * C >= 2**31:
        raise ValueError(f"Y too large for the kernel's 32-bit indices: {tuple(Y.shape)}")
    if out is None:
        out = torch.empty((B, C, C), dtype=torch.float32, device=Y.device)
    elif (out.shape != (B, C, C) or out.dtype != torch.float32
          or out.device != Y.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 (B, C, C) tensor on Y's device")
    if N == 0:
        return out.zero_()
    strides = _tma_strides(Y)
    if strides is None:
        buf = torch.empty((N, B, C + (-C % 4)), dtype=torch.float32, device=Y.device)
        buf[..., :C].copy_(Y)
        Y = buf[..., :C]
        strides = _tma_strides(Y)
    plan = _plan(N, B, C, _sm_count(Y.device.index))
    ws = torch.empty(plan.splits * B * plan.tiles * plan.tile_elems,
                     dtype=torch.float32, device=Y.device)
    fn = _lib()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        counters = _tile_counters(Y.device, stream, B * plan.tiles)
        err = fn(Y.data_ptr(), N, B, C, strides[0], strides[1], plan.panel, int(plan.pairs),
                 plan.rows, plan.splits, ws.data_ptr(), counters.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: error {err}")
    launches += 1
    launch_shapes[(N, B, C)] += 1
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
    aug = cat_padded([Y, tau[:, None]])
    G = gram(aug)
    P = Y.shape[1]
    return G[:P, :P], G[:P, P], G[P, P]
