"""The port's Gram op (flobaroid_tpu_torch.ops.gram) against the JAX one.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX XLA path (gram_xla / gram_augmented) and against the
Pallas TPU kernel in interpret mode. The CUDA kernel itself is compared
with the plain version in test_torch_cuda.py, where a card is present.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.ops import gram as jgram
from flobaroid_tpu_torch.ops import gram as tgram

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")

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
    """The kernel's launch plan: every row in exactly one split, each split
    a whole number of 32-row pipeline steps, no block summing more than
    _MAX_ROWS rows, panels that cover C, and the split count of least
    modelled time among those allowed."""
    plan = tgram._plan(N, B, C, sms=132)
    assert plan.rows % 32 == 0 and plan.rows <= tgram._MAX_ROWS
    assert (plan.splits - 1) * plan.rows < N <= plan.splits * plan.rows
    if C <= 128:
        assert not plan.pairs and plan.tiles == 1
        assert plan.panel % 32 == 0 and C <= plan.panel < C + 32
    else:
        nt = -(-C // 128)
        assert plan.pairs and plan.panel == 128 and plan.tiles == nt * (nt + 1) // 2
    allowed = range(-(-N // tgram._MAX_ROWS), max(1, -(-N // tgram._MIN_ROWS)) + 1)
    costs = {S: tgram._plan_cost(N, B, plan.tiles, S, 132) for S in allowed if S >= 1}
    assert costs[plan.splits] == min(costs.values())


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as plain arithmetic: round to nearest, ties away
    from zero, at TF32's 10 mantissa bits (add half of the dropped range
    to the bits, then mask the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _regressor_chunk() -> torch.Tensor:
    """A real 7-DOF per-channel chunk (4096, 7, 82): the port's regressor
    on seeded states, with the simulated torque and a zero contact column
    appended, as the streamed Gram site builds it."""
    from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
    from flobaroid_tpu_torch.models.urdf import load_urdf

    tree = load_urdf(ARM_URDF)
    rng = np.random.default_rng(7)
    q, dq, ddq = (torch.tensor(rng.uniform(-2, 2, (4096, 7)), dtype=torch.float32) for _ in range(3))
    Y = DynamicsEngine(tree).regressor_batch(q, dq, ddq)
    tau = Y @ torch.tensor(tree.std_params(), dtype=torch.float32)
    return torch.cat([Y, tau[..., None], torch.zeros_like(tau)[..., None]], dim=2)


@pytest.mark.parametrize("case", ["regressor_4096x7x82", "randn_2048x2x342"])
def test_tf32_split_keeps_f32_accuracy(case):
    """The kernel's arithmetic on the CPU: y = hi + lo with both rounded to
    TF32, G = hi^T hi + hi^T lo + lo^T hi (lo^T lo dropped), products and
    sums exact in f64. Within 1e-6 of max|G| against the f64 Gram: the
    split itself costs ~2^-22, well inside the kernel's 1e-5 gate."""
    if case.startswith("regressor"):
        Y = _regressor_chunk()
    else:
        Y = torch.tensor(np.random.default_rng(3).standard_normal((2048, 2, 342)), dtype=torch.float32)
    hi = _tf32_rna(Y)
    lo = _tf32_rna(Y - hi)
    assert torch.equal(hi, _tf32_rna(hi)) and (Y - hi - lo).abs().max() <= 2.0**-21 * Y.abs().max()
    h, l = hi.double(), lo.double()
    G = tgram.gram_plain(h) + torch.einsum("nbp,nbq->bpq", h, l) + torch.einsum("nbp,nbq->bpq", l, h)
    G64 = tgram.gram_plain(Y.double())
    assert float((G - G64).abs().max() / G64.abs().max()) <= 1e-6
    # one pass of plain TF32 (no split) would not meet the gate
    assert float((tgram.gram_plain(h) - G64).abs().max() / G64.abs().max()) > 1e-5


@pytest.mark.parametrize("widths", [(80,), (80, 1, 1), (37,), (5, 3, 1)])
def test_padded_gram_sites_match_the_plain_cat(widths):
    """cat_padded builds the Gram sites' Y with 16-byte rows that the
    kernel's tensor map reads in place, and on the CPU gives the same Y
    and the same Gram as the plain torch.cat."""
    rng = np.random.default_rng(sum(widths))
    parts = [torch.tensor(rng.standard_normal((300, 7, w))) for w in widths]
    Y = tgram.cat_padded(parts)
    ref = torch.cat(parts, dim=-1)
    assert torch.equal(Y, ref)
    assert Y.stride(0) % 4 == 0 and Y.stride(1) % 4 == 0 and Y.stride(2) == 1
    assert tgram._tma_strides(Y) == (Y.stride(0), Y.stride(1))
    assert torch.allclose(tgram.gram_batched(Y), tgram.gram_plain(ref), rtol=1e-13, atol=0)
    flat = Y.reshape(-1, 1, Y.shape[-1])  # the structural site's B = 1 view, no copy
    assert flat.data_ptr() == Y.data_ptr() and tgram._tma_strides(flat) is not None
    if ref.shape[-1] % 4:
        assert tgram._tma_strides(ref) is None  # a contiguous odd width is copied first
