"""Sample- and candidate-axis sharding over devices, in one process.

Counterpart of flobaroid_tpu/parallel/mesh.py. The JAX package shards in
one process: one controller drives an n-device Mesh, the leading (sample
or candidate) axis of a batch is split over it and partial Grams are
summed with psum. The port does the same without a launcher: shard i's
slice of a batch goes to mesh device i, and each shard's partial result
is copied to the primary device (the caller's) and summed there in f64,
in shard order, so a sharded result is the same run to run and differs
from the unsharded one by summation order only.

On CUDA shard i lives on cuda:((k + i) mod device_count), where cuda:k
is the caller's device (shard 0 on it). With fewer cards
than shards several shards share a card (the JAX package runs unsharded
then): the sharded code still runs, one shard after another. On the CPU
the mesh is n entries of `cpu`, the counterpart of the virtual host
devices the JAX tests run on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gram import cat_padded, gram_batched


@dataclass(frozen=True)
class Mesh:
    """The devices of the shards, shard i on devices[i], and the name of
    the axis they split ("samples" or "candidates")."""

    devices: tuple[torch.device, ...]
    axis: str = "samples"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device="cuda", axis: str = "samples") -> Mesh:
    """A mesh of n_devices shards on `device`'s type, shard 0 on `device`
    and shard i on the i-th card after it (default: one shard per visible
    card on CUDA, one on the CPU). With fewer cards than shards it prints
    one line and places several shards on a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None else dev.index
        n = count if n_devices is None else int(n_devices)
        if n > count:
            print(f"{axis} mesh of {n} shards but only {count} CUDA device(s) visible — "
                  f"{n} shards share {count} card(s)")
        devices = tuple(torch.device("cuda", (first + i) % count) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        devices = (dev,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(devices, axis)


def shard_slices(n: int, shards: int) -> list[slice]:
    """The n-row leading axis cut into `shards` contiguous slices of
    ceil(n / shards) rows, the last ones shorter; empty slices are left
    out (a short tail gives fewer shards, and nothing runs for the rest)."""
    sub = -(-n // shards) if n else 0
    return [slice(i * sub, min((i + 1) * sub, n)) for i in range(shards) if i * sub < n]


def shard_batch(mesh: Mesh, *arrays, dtype=None):
    """Each array's leading axis split into the mesh's contiguous shard
    slices (`shard_slices`), shard i as a tensor on mesh device i: one
    tuple of shards per array."""
    out = []
    for a in arrays:
        sls = shard_slices(len(a), mesh.size)
        out.append(tuple(torch.as_tensor(a[sl], dtype=dtype).to(dev)
                         for sl, dev in zip(sls, mesh.devices)))
    return tuple(out)


def pad_to_multiple(a: np.ndarray, m: int):
    """Zero-pad the leading axis to a multiple of m (returns array, n_valid)."""
    n = a.shape[0]
    r = (-n) % m
    if r == 0:
        return a, n
    pad = np.zeros((r,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0), n


def sharded_gram_fn(engine, mesh: Mesh, floating: bool = False):
    """fn(Q, DQ, DDQ, TAU[, BR, BV, BA]) -> (Y^T Y, Y^T tau) in f64 on the
    first mesh device, for arguments sharded by `shard_batch` (Q, DQ, DDQ
    (N, n), TAU (N, rows), the base series of a floating base). Each shard
    builds its regressor and makes one launch of the Gram kernel on
    [Y | tau] (B = 1, every output row a sample row); the partial Grams
    are summed in f64 in shard order."""

    def fn(Q, DQ, DDQ, TAU, BR=None, BV=None, BA=None):
        args = (Q, DQ, DDQ, TAU) + ((BR, BV, BA) if floating else ())
        primary = mesh.devices[0]
        total = None
        for q, dq, ddq, tau, *b in zip(*args):
            Y = engine.regressor_batch(q, dq, ddq, *b)  # (n, rows, P)
            aug = cat_padded([Y, tau.to(Y.dtype)[:, :, None]])
            part = gram_batched(aug.reshape(-1, 1, aug.shape[-1]))[0].double().to(primary)
            total = part if total is None else total + part
        P = total.shape[0] - 1
        return total[:P, :P], total[:P, P]

    return fn
