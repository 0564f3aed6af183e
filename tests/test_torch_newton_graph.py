"""The SDP Newton step's CUDA graph (`conic.QuadBarrierSolver._step`) on the
CPU: the packed step equals the unpacked step it replaced bit for bit, on
the block-sparse and the dense barrier; `_armijo` picks its step on the
device with the old selection's value; a solver's cache runs eager until
its `NEWTON_GRAPH_CAPTURE_AT`-th step, captures once and replays after,
per solver (the phase-I solver has its own); CPU solvers never reach a
cache; the closest-to-CAD projection keeps one solver, not one a
recording. The capture is a stub here; the graphs themselves run in
tests/test_torch_cuda.py on the card."""

import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flobaroid_tpu_torch.identification import conic
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.utils import graphs, timing
from flobaroid_tpu_torch.utils.config import load_config

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def _problem(dense, seed=0):
    """(A, b, psd_maps, n, x0): stacked 4 × 4 PSD blocks and linear rows,
    strictly feasible at x0 = 0. Sparse: each block and row touches a few of
    the variables (the block-sparse scatter); dense: every block and row
    touches all of them (the dense products)."""
    rng = np.random.default_rng(seed)
    n, K, d, m = (10, 2, 4, 6) if dense else (24, 5, 4, 8)
    F = rng.normal(0, 0.1, (K, d, d, n))
    F = (F + np.swapaxes(F, 1, 2)) / 2
    A = rng.normal(0, 0.2, (m, n))
    if not dense:
        for k in range(K):
            F[k, :, :, rng.permutation(n)[6:]] = 0
        for i in range(m):
            A[i, rng.permutation(n)[3:]] = 0
    b = np.abs(rng.normal(2, 0.5, m))
    maps = [lambda x, k=k: 2.0 * np.eye(d) + F[k] @ x for k in range(K)]
    return A, b, maps, n, np.zeros(n)


def _objective(n, seed=1):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = M @ M.T + np.eye(n)
    return H, -H @ rng.normal(0, 2.0, n)


def _solver(dense):
    A, b, maps, n, x0 = _problem(dense)
    s = conic.QuadBarrierSolver(A, b, maps, 1e-6, n, device="cpu")
    sparse = s.core.groups[0][2] is not None and s.core._A_sp is not None
    assert sparse != dense
    return s, x0


def _old_armijo(x, dx, dec, vals_ext, steps):
    """The selection before the packed step: the chosen step read through a
    0-d integer index (a host sync on a card)."""
    vals = vals_ext[1:]
    ok = torch.isfinite(vals) & (vals <= vals_ext[0] - 1e-4 * steps * dec)
    any_ok = ok.any()
    step_sel = torch.where(any_ok, steps[ok.to(torch.int8).argmax()], 0.0)
    return torch.where(any_ok, x + step_sel * dx, x), dec, any_ok, step_sel


def _old_newton_step(s, x, t, H, q):
    """`QuadBarrierSolver._newton_step` before the graph: t a Python float,
    the result unpacked."""
    gb, Hb = s.core.grad_hess(x)
    Hx_q = H @ x + q
    dx, dec = conic._newton_direction(t * Hx_q + gb, t * H + Hb)
    e = s._steps_ext
    quad_ext = s._quad(x, H, q) + e * (dx @ Hx_q) + e**2 * (0.5 * dx @ (H @ dx))
    vals_ext = t * quad_ext + s.core.ray_values(x, dx, e)
    return _old_armijo(x, dx, dec, vals_ext, s._steps)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_packed_step_equals_the_unpacked_step(dense):
    """Along a centering path at three barrier parameters: [x_new, dec, ok,
    step] from t as a 0-d f64 tensor equals the old (x_new, dec, ok, step)
    from t as a float, bit for bit."""
    s, x0 = _solver(dense)
    H, q = (torch.as_tensor(a, dtype=F64) for a in _objective(s.n))
    n = s.n
    steps = 0
    for t in (0.37, 12.0, 4.1e3):
        x = torch.as_tensor(x0, dtype=F64)
        for _ in range(6):
            out = s._newton_step(x, torch.tensor(t, dtype=F64), H, q)
            x_old, dec, ok, size = _old_newton_step(s, x, t, H, q)
            assert out.shape == (n + 3,) and out.dtype == F64
            assert torch.equal(out[:n], x_old)
            assert torch.equal(out[n:], torch.stack([dec, ok.to(F64), size]))
            steps += bool(ok)
            x = out[:n]
    assert steps >= 12  # the line search took steps, not only the gradient's fallback


NAN = float("nan")
ARMIJO_CASES = {  # values at [0, steps], of which these pass the test
    "first ok": [1.0, 0.5, 0.9, 0.95],
    "middle ok": [1.0, 1.2, 1.1, 0.9],
    "none ok": [1.0, 1.2, 1.1, 1.05],
    "nan values": [1.0, NAN, NAN, 0.99],
    "all nan": [1.0, NAN, NAN, NAN],
}


@pytest.mark.parametrize("case", list(ARMIJO_CASES))
def test_armijo_selects_the_old_step_without_a_host_read(case):
    x, dx = torch.tensor([0.5, -1.0], dtype=F64), torch.tensor([0.25, 2.0], dtype=F64)
    dec = torch.tensor(0.3, dtype=F64)
    vals_ext = torch.tensor(ARMIJO_CASES[case], dtype=F64)
    steps = torch.tensor([1.0, 0.5, 0.25], dtype=F64)
    out = conic._armijo(x, dx, dec, vals_ext, steps)
    x_old, dec_old, ok, size = _old_armijo(x, dx, dec, vals_ext, steps)
    assert torch.equal(out, torch.cat([x_old, torch.stack([dec_old, ok.to(F64), size])]))
    first = {"first ok": 1.0, "middle ok": 0.25, "nan values": 0.25}.get(case, 0.0)
    assert float(out[-1]) == first and bool(out[-2]) == (first > 0)


@pytest.fixture
def captures(monkeypatch):
    """`graphs.Captured` replaced by a stub whose calls run the function
    eagerly; the list of the first args of every capture."""
    made = []

    class Stub:
        def __init__(self, fn, args):
            self.fn = fn
            made.append(args[0])

        def __call__(self, args):
            return self.fn(*args)

    monkeypatch.setattr(graphs, "Captured", Stub)
    return made


def _with_cache(solver):
    """The solver with the cache a card's solver holds."""
    solver._graph = graphs.GraphCache(1, conic.NEWTON_GRAPH_CAPTURE_AT)
    return solver


def _traced(fn):
    """fn() inside a profiler session: (its result, the counters, the step
    records' replay attributes)."""
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counters = timing.counters()
    replays = [r.attrs["sdp_newton_graph_replays"] for r in timing.records()
               if r.name == "sdp/newton_step"]
    timing.reset()
    return out, counters, replays


def test_a_solver_captures_once_then_replays(captures):
    """Two solves on one solver: the first cold ladder captures at the
    solver's NEWTON_GRAPH_CAPTURE_AT-th step, and every later step of both
    solves replays; the result equals the eager solver's."""
    k = conic.NEWTON_GRAPH_CAPTURE_AT
    H, q = _objective(24)
    eager, x0 = _solver(False)
    graphed = _with_cache(_solver(False)[0])
    (x, status), c, replays = _traced(lambda: graphed.minimize(x0, H, q))
    assert c["sdp_newton_steps"] > k
    assert c["sdp_newton_graph_captures"] == 1 and len(captures) == 1
    assert replays == [0] * k + [1] * (c["sdp_newton_steps"] - k)
    assert c["sdp_newton_graph_replays"] == c["sdp_newton_steps"] - k
    x_eager, status_eager = eager.minimize(x0, H, q)
    assert status == status_eager == "optimal" and np.array_equal(x, x_eager)
    assert graphed.last_info["newton_iters"] == eager.last_info["newton_iters"]
    (x, _), c, replays = _traced(lambda: graphed.minimize(x0, H, 1.1 * q))  # warm start
    assert "sdp_newton_graph_captures" not in c and len(captures) == 1
    assert replays == [1] * c["sdp_newton_steps"]
    assert np.array_equal(x, eager.minimize(x0, H, 1.1 * q)[0])


def test_a_short_cold_solve_never_captures(captures):
    H, q = _objective(24)
    s, x0 = _solver(False)
    _with_cache(s)
    _, c, replays = _traced(lambda: s.minimize(x0, H, q, gap_tol=1e-1, max_newton=2))
    assert 0 < c["sdp_newton_steps"] < conic.NEWTON_GRAPH_CAPTURE_AT
    assert "sdp_newton_graph_captures" not in c and not captures
    assert replays == [0] * c["sdp_newton_steps"]
    assert s._graph.entries["newton_step"] == c["sdp_newton_steps"]  # eager steps so far


def test_the_phase1_solver_keeps_its_own_graph(captures):
    """An infeasible start runs the lifted phase-I solver (n + 1 variables)
    first: it counts, captures and replays its own steps, and the main solver
    captures at its own NEWTON_GRAPH_CAPTURE_AT-th step."""
    k = conic.NEWTON_GRAPH_CAPTURE_AT
    A, b, maps, n, _ = _problem(False)
    s = _with_cache(conic.QuadBarrierSolver(A, b, maps, 1e-6, n, device="cpu"))
    p1 = _with_cache(s._phase1_solver())
    assert s._phase1_solver() is p1 and p1._graph is not s._graph
    H, q = _objective(n)
    x_bad = np.full(n, 40.0)
    assert s._feas_slack(s._t(x_bad)) > 0
    (_, status), c, _ = _traced(lambda: s.solve_quadratic(x_bad, H, q))
    assert status == "optimal"
    assert [a.shape[0] for a in captures] == [n + 1, n]  # phase I's graph first
    assert c["sdp_newton_graph_captures"] == 2
    assert c["sdp_newton_graph_replays"] == c["sdp_newton_steps"] - 2 * k
    assert isinstance(p1._graph.entries["newton_step"], graphs.Captured)
    assert isinstance(s._graph.entries["newton_step"], graphs.Captured)


def test_cpu_solvers_never_reach_a_cache(captures):
    """A CPU solver and its phase-I solver hold no cache, and every step of
    an infeasible-start solve runs eager."""
    A, b, maps, n, _ = _problem(False)
    s = conic.QuadBarrierSolver(A, b, maps, 1e-6, n, device="cpu")
    H, q = _objective(n)
    (_, status), c, replays = _traced(lambda: s.solve_quadratic(np.full(n, 40.0), H, q))
    assert status == "optimal" and c["sdp_newton_steps"] > 2 * conic.NEWTON_GRAPH_CAPTURE_AT
    assert s._graph is None and s._phase1_solver()._graph is None
    assert replays == [0] * c["sdp_newton_steps"]
    assert c["sdp_newton_graph_replays"] == 0 and "sdp_newton_graph_captures" not in c
    assert not captures


@pytest.mark.timeout(120)
def test_closest_to_cad_keeps_one_projection_solver(tmp_path):
    """identifyClosestToCAD builds a solver for the base projection of each
    identification (its rows hold that xBase): two recordings leave one such
    solver, the newest, beside the main solver, so that a card does not keep
    a graph per identification."""
    urdf = tmp_path / "arm.urdf"
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + ".regressor.npz", str(urdf) + ".regressor.npz")
    opt = dict(floatingBase=0, useStructuralRegressor=1, randomSamples=600, estimateWith="std",
               materializeRegressor=0, constrainToConsistent=1, limitOverallMass=1,
               limitMassRange=1.0, limitMassToApriori=1, limitMassAprioriBoundary=0.3,
               identifyClosestToCAD=1, computeDtype="float64", verbose=0)
    idf = Identification(load_config(None, overrides=opt), str(urdf), device="cpu")
    made = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        n = 400
        idf.data.init_from_data(dict(
            positions=rng.uniform(-1, 1, (n, 7)), velocities=rng.standard_normal((n, 7)),
            accelerations=rng.standard_normal((n, 7)), torques=rng.standard_normal((n, 7)),
            times=np.arange(n) / 200.0, frequency=np.array(200.0)))
        idf.estimateParameters()
        assert idf.sdp.last_status == "optimal"
        ext = [k for k in idf.sdp._solver_cache if k[0] == "ext"]
        assert len(ext) == 1 and ext[0] not in made
        assert idf.sdp._last_solver is idf.sdp._solver_cache[ext[0]]
        made.append(ext[0])
    assert sorted(k[0] for k in idf.sdp._solver_cache) == ["ext", "main"]
