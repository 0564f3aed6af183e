"""The port's Gram op (flobaroid_tpu_torch.ops.gram) against the JAX one.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX XLA path (gram_xla / gram_augmented) and against the
Pallas TPU kernel in interpret mode. The CUDA kernel itself is compared
with the plain version in test_torch_cuda.py, where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.ops import gram as jgram
from flobaroid_tpu_torch.ops import gram as tgram

torch.set_num_threads(2)

RAGGED = [(300, 37), (1037, 37), (1, 5), (129, 82), (64, 1)]


@pytest.mark.parametrize("M,P", RAGGED)
def test_gram_matches_jax_xla(M, P):
    Y = np.random.default_rng(M + P).standard_normal((M, P)).astype(np.float32)
    Gj = np.asarray(jgram.gram_xla(jnp.asarray(Y)))
    for fn in (tgram.gram, tgram.gram_xla):
        Gt = fn(torch.tensor(Y))
        assert Gt.dtype == torch.float32 and tuple(Gt.shape) == (P, P)
        np.testing.assert_allclose(Gt.numpy(), Gj, rtol=1e-5, atol=1e-5 * np.abs(Gj).max())


@pytest.mark.parametrize("M,P", [(300, 37), (1024, 16), (2048 + 77, 40)])
def test_gram_matches_pallas_interpret(M, P):
    """Against the TPU kernel run in interpret mode: the bf16 hi/lo split
    keeps ~3e-6 of max|G|, hence the interpret-mode tolerance of
    tests/test_ops_parallel.py (rtol 1e-4, atol 5e-3)."""
    Y = np.random.default_rng(M).standard_normal((M, P)).astype(np.float32)
    Gk = np.asarray(jgram.gram_pallas(jnp.asarray(Y), row_tile=128, interpret=True))
    Gt = tgram.gram(torch.tensor(Y))
    np.testing.assert_allclose(Gt.numpy(), Gk, rtol=1e-4, atol=5e-3)


def test_gram_augmented_matches_jax():
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((200, 20)).astype(np.float32)
    tau = rng.standard_normal(200).astype(np.float32)
    Gj, gj, tj = (np.asarray(a) for a in jgram.gram_augmented(jnp.asarray(Y), jnp.asarray(tau)))
    Gt, gt, tt = tgram.gram_augmented(torch.tensor(Y), torch.tensor(tau))
    np.testing.assert_allclose(Gt.numpy(), Gj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-5)


@pytest.mark.parametrize("N,B,C", [(2000, 7, 82), (333, 3, 41), (1, 2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_per_channel_gram_matches_jax(N, B, C, dtype):
    """The main path's form: B per-channel Grams of (N, B, C), augmented
    columns included — the same numbers as JAX's per-channel einsum."""
    Y = np.random.default_rng(N * B).standard_normal((N, B, C))
    if dtype == torch.float32:
        Y = Y.astype(np.float32)
    Gj = np.stack([np.asarray(jgram.gram_xla(jnp.asarray(Y[:, b]))) for b in range(B)]) \
        if dtype == torch.float32 else np.einsum("nbp,nbq->bpq", Y, Y)
    Gt = tgram.gram_batched(torch.tensor(Y))
    assert Gt.dtype == dtype and tuple(Gt.shape) == (B, C, C)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(Gt.numpy() - Gj).max() <= tol * np.abs(Gj).max()
    # strided input (a transposed view) gives the same Gram, and out= is filled
    Yt = torch.tensor(Y).permute(1, 0, 2).contiguous().permute(1, 0, 2)
    out = torch.empty((B, C, C), dtype=dtype)
    assert tgram.gram_batched(Yt, out=out) is out
    assert torch.equal(out, Gt)


def test_cpu_path_runs_the_plain_version_and_counts_no_launch():
    before = tgram.launches
    Y = torch.randn(50, 2, 9, dtype=torch.float64)
    assert torch.equal(tgram.gram_batched(Y), tgram.gram_plain(Y))
    assert tgram.launches == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tgram.gram_batched(torch.zeros(4, 5))
    with pytest.raises(TypeError):
        tgram.gram_batched(torch.zeros(4, 1, 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        tgram.gram_batched(torch.zeros(4, 1, 5, device="meta"))  # neither CPU nor CUDA


@pytest.mark.parametrize("N,B,C", [(14000, 1, 80), (2000, 7, 82), (60000, 7, 82),
                                   (13770, 30, 342), (1037, 1, 37), (5, 3, 1)])
def test_row_splits_cover_rows_and_bound_chains(N, B, C):
    """The kernel's row split: every row in exactly one split, each split
    a multiple of the 32-row staging step, no thread summing more than
    2048 rows, and enough blocks for 132 SMs whenever N allows."""
    rows, S = tgram._row_splits(N, B, C, sms=132)
    nt = -(-C // 32)
    assert rows % 32 == 0 and rows <= 2048 + 31
    assert (S - 1) * rows < N <= S * rows
    assert S * B * nt * (nt + 1) // 2 >= min(4 * 132, B * nt * (nt + 1) // 2 * -(-N // 128))
