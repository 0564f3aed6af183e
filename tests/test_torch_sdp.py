"""The port's SDP layer and barrier solver against the JAX package.

The constraint sets both packages build for the 7-DOF arm must be equal,
and both QuadBarrierSolvers, given the same quadratic, must land on the
same point (in the directions where the minimizer is unique) with the
same certificate status. The solver's building blocks (sparse barrier
derivatives, warm start, stop, certificate under stress) are checked as
tests/test_sdp.py checks the JAX ones.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flobaroid_tpu.identification.conic as jconic
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.identification import conic
from flobaroid_tpu_torch.identification.conic import QuadBarrierSolver
from flobaroid_tpu_torch.identification.identifier import Identification

from test_identification import synth_samples

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def sdp_opt(**kw):
    return load_config(None, overrides={**dict(
        verbose=0, floatingBase=0, useStructuralRegressor=1, randomSamples=600,
        computeDtype="float64", estimateWith="std", materializeRegressor=0,
        constrainToConsistent=1, limitOverallMass=1, limitMassRange=1.0,
        limitMassToApriori=1, limitMassAprioriBoundary=0.3), **kw})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX and port identifications of the arm on the same noisy samples,
    with the quadratic the JAX SDP solved recorded."""
    d = tmp_path_factory.mktemp("torch_sdp_arm")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz", ARM_URDF + ".gravity_regressor.npz"):
        shutil.copy(f, d)
    urdf = str(d / "sevenlink_arm.urdf")
    samples, _ = synth_samples(urdf, n=800, noise=0.05, seed=21)
    jidf = JaxIdentification(sdp_opt(), urdf)
    tidf = Identification(sdp_opt(), urdf, device="cpu")
    tidf.model.load_state(state_from_jax_model(jidf.model))
    recorded = []
    orig = jconic.QuadBarrierSolver.solve_quadratic

    def record(self, x0, H, q, const=0.0, **kw):
        recorded.append((np.array(x0), np.array(H), np.array(q), float(const)))
        return orig(self, x0, H, q, const, **kw)

    jconic.QuadBarrierSolver.solve_quadratic = record
    try:
        jidf.data.init_from_data(dict(samples))
        jidf.estimateParameters()
    finally:
        jconic.QuadBarrierSolver.solve_quadratic = orig
    tidf.data.init_from_data(dict(samples))
    tidf.estimateParameters()
    return jidf, tidf, recorded[0]


def test_constraint_sets_match(pair):
    jidf, tidf, _ = pair
    js, ts = jidf.sdp, tidf.sdp
    assert ts.free_params == js.free_params
    assert ts.delete_cols == js.delete_cols
    assert np.array_equal(ts.A, js.A) and np.array_equal(ts.b, js.b)
    n = len(js.free_params)
    with jax.enable_x64(True):
        jg = jconic.stack_affine_psd(js.psd_maps, n)
    tg = conic.stack_affine_psd(ts.psd_maps, n)
    assert len(jg) == len(tg) == 1
    for (F0j, Fj), (F0t, Ft) in zip(jg, tg):
        assert np.array_equal(F0t, F0j) and np.array_equal(Ft, Fj)


def _fresh_solvers(jidf, tidf):
    js, ts = jidf.sdp, tidf.sdp
    n = len(js.free_params)
    return (jconic.QuadBarrierSolver(js.A, js.b, js.psd_maps, js.epsilon_safemargin, n),
            QuadBarrierSolver(ts.A, ts.b, ts.psd_maps, ts.epsilon_safemargin, n, device="cpu"))


def test_solve_quadratic_matches_jax_on_a_projection(pair):
    """Fresh solvers of both packages on a strictly convex quadratic over
    the arm's constraint set: the closest feasible point to a perturbed
    a-priori vector (findFeasibleStdFromStd's objective), whose minimizer
    is unique."""
    jidf, tidf, _ = pair
    x0 = jidf.sdp._x0_free()
    rng = np.random.default_rng(2)
    target = x0 * (1.0 + 0.5 * rng.standard_normal(x0.size)) + 0.01 * rng.standard_normal(x0.size)
    n = x0.size
    args = (x0, 2.0 * np.eye(n), -2.0 * target, float(target @ target))
    jsol, tsol = _fresh_solvers(jidf, tidf)
    xj, sj = jsol.solve_quadratic(*args)
    xt, st = tsol.solve_quadratic(*args)
    assert st == sj == "optimal"
    assert tsol.last_info["certify_iters"] == jsol.last_info["certify_iters"] == 0
    assert np.linalg.norm(xt - np.asarray(xj)) <= 1e-6 * np.linalg.norm(xj)
    assert tsol.last_info["max_violation"] <= 0.0
    assert np.linalg.norm(xt - target) > 1e-3  # some constraint is active


def test_solve_quadratic_matches_jax_on_the_identification(pair):
    """Both solvers on the quadratic the JAX identification solved. Its
    minimizer is unique only in the identifiable (base) directions: the
    rest of x* is set by the barrier at the last rung, and the JAX solver
    itself moves it by ~4e-5 under a 1e-13 relative change of H. So the
    base part K x* and the objective are compared, not the whole of x*."""
    jidf, tidf, (x0, H, q, const) = pair
    jsol, tsol = _fresh_solvers(jidf, tidf)
    xj, sj = jsol.solve_quadratic(x0, H, q, const)
    xt, st = tsol.solve_quadratic(x0, H, q, const)
    xj = np.asarray(xj)
    assert st == sj == "optimal"
    assert tsol.last_info["certify_iters"] == jsol.last_info["certify_iters"] == 0
    js = jidf.sdp
    K = np.delete(jidf.model.K, js.delete_cols, axis=1)

    def base(x):
        return K @ (js._scatter @ x + js._fixed_vec)

    assert np.linalg.norm(base(xt) - base(xj)) <= 1e-6 * np.linalg.norm(base(xj))

    def f(x):
        return 0.5 * x @ H @ x + q @ x + const

    assert abs(f(xt) - f(xj)) <= 1e-9 * max(abs(const), 1.0)


def test_certification_when_the_ladder_stops_short(pair):
    """The one place where the port's policy differs from the JAX solver:
    when no candidate qualifies for 'optimal' although a stage reached the
    quadratic zone (here: gap_tol=1e-2 stops the ladder two rungs below
    the certifying one), the port runs the explicit certification rung
    where the JAX solver returns a non-optimal status. The port's point
    must then lie within its certificate of the optimum that the JAX
    solver reaches with its full ladder."""
    jidf, tidf, (x0, H, q, const) = pair
    jshort, tshort = _fresh_solvers(jidf, tidf)
    xj_short, sj_short = jshort.solve_quadratic(x0, H, q, const, gap_tol=1e-2)
    xt, st = tshort.solve_quadratic(x0, H, q, const, gap_tol=1e-2)
    assert jshort.last_info["certify_iters"] == 0 and sj_short != "optimal"
    info = tshort.last_info
    assert info["certify_iters"] > 0 and st == "optimal"
    assert info["cert_gap_rel"] < 1e-3 and info["max_violation"] <= 0.0
    jfull, _ = _fresh_solvers(jidf, tidf)
    xj, sj = jfull.solve_quadratic(x0, H, q, const)
    assert sj == "optimal"

    def f(x):
        return 0.5 * x @ H @ x + q @ x + const

    # certificate in the quadratic's own units (the solver ran it scaled)
    cert_gap = info["cert_gap_rel"] * info["gap"] / info["gap_rel"]
    jgap = jfull.last_info["gap"]
    assert -jgap <= f(xt) - f(np.asarray(xj)) <= cert_gap
    assert f(xt) < f(np.asarray(xj_short))


def test_identification_sdp_matches_jax(pair):
    """End of the SDP stage: the same status, the same base parameters
    (xBase = K xStd) and residual."""
    jidf, tidf, _ = pair
    jm, tm = jidf.model, tidf.model
    assert tidf.sdp.last_status == jidf.sdp.last_status == "optimal"
    assert np.linalg.norm(tm.xBase - jm.xBase) <= 1e-6 * np.linalg.norm(jm.xBase)
    assert abs(tidf.res_error - jidf.res_error) <= 1e-6 * jidf.res_error


@pytest.mark.parametrize("name", ["spatial_inertia_map", "pseudo_inertia_map"])
def test_inertia_maps_match_jax(name):
    """The port's numpy inertia maps against the JAX ones, through a
    lookup that pins one entry (as fixed parameters are pinned)."""
    import flobaroid_tpu.identification.sdp as jsdp
    from flobaroid_tpu_torch.identification import sdp as tsdp

    x = np.random.default_rng(8).standard_normal(30)

    def lookup(v, i):
        return 0.25 if i == 14 else v[i]

    for link in range(3):
        with jax.enable_x64(True):
            Mj = np.asarray(getattr(jsdp, name)(lookup, link)(jnp.asarray(x)))
        Mt = getattr(tsdp, name)(lookup, link)(x)
        assert Mt.shape == Mj.shape and np.array_equal(Mt, Mj)
        assert np.array_equal(Mt, Mt.T)


def test_sparse_barrier_parity_with_jax():
    """Block-sparse barrier value/gradient/Hessian (index_add_ /
    index_put_ scatter) against the JAX core and the port's dense path."""
    rng = np.random.default_rng(0)
    n, K, d, m = 60, 7, 4, 12
    F = rng.normal(0, 0.1, (K, d, d, n))
    F = (F + np.swapaxes(F, 1, 2)) / 2
    for k in range(K):
        msk = np.zeros(n, bool)
        msk[rng.choice(n, 9, replace=False)] = True
        F[k, :, :, ~msk] = 0
    F0 = np.broadcast_to(np.eye(d) * 2.0, (K, d, d)).copy()
    A = np.zeros((m, n))
    for i in range(m):
        A[i, rng.choice(n, 3, replace=False)] = rng.normal(0, 0.2, 3)
    b = np.abs(rng.normal(2, 0.5, m))
    x = rng.normal(0, 0.05, n)
    core = conic._BarrierCore(A, b, [(F0, F)], 1e-6, n, torch.device("cpu"))
    dense = conic._BarrierCore(A, b, [(F0, F)], 1e-6, n, torch.device("cpu"))
    dense.groups = [(g[0], g[1], None, None) for g in dense.groups]
    dense._A_sp = None
    assert core.groups[0][2] is not None and core._A_sp is not None
    with jax.enable_x64(True):
        jcore = jconic._BarrierCore(A, b, [(F0, F)], 1e-6, n)
        vj = float(jcore.value(jnp.asarray(x)))
        gj, Hj = (np.asarray(a) for a in jcore.grad_hess(jnp.asarray(x)))
    xt = torch.tensor(x)
    for c in (core, dense):
        g, H = c.grad_hess(xt)
        np.testing.assert_allclose(float(c.value(xt)), vj, rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-10, atol=1e-12)


def test_infeasible_point_reads_as_nan_not_an_error():
    """A non-PD block makes the barrier value non-finite (cholesky_ex
    info -> NaN), which the line search and the start test rely on."""
    solver = QuadBarrierSolver(A=None, b=None, psd_maps=[lambda x: np.diag(x[:2])],
                               psd_eps=1e-3, n=2, device="cpu")
    assert not np.isfinite(float(solver.core.value(torch.tensor([1.0, -1.0], dtype=torch.float64))))
    assert np.isfinite(float(solver.core.value(torch.tensor([1.0, 1.0], dtype=torch.float64))))
    xf, ok = solver.phase1(np.array([-1.0, -2.0]))
    assert ok and np.all(xf > 1e-3)
    x, status = solver.solve_quadratic(np.array([1.0, 1.0]), 2 * np.eye(2), -4 * np.ones(2))
    assert status == "optimal" and np.allclose(x, 2.0, atol=1e-4)


def test_warm_start_matches_cold():
    """Port of tests/test_sdp.py::test_conic_warm_start_matches_cold."""
    rng = np.random.default_rng(11)
    n = 8
    M = rng.normal(size=(n, n))
    H = M @ M.T + np.eye(n)
    x_tgt = np.full(n, 0.5)
    q = -H @ x_tgt
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.full(2 * n, 1.0)

    warm = QuadBarrierSolver(A=A, b=b, psd_maps=[], psd_eps=1e-6, n=n, device="cpu")
    x1, s1 = warm.solve_quadratic(np.zeros(n), H, q)
    assert s1 == "optimal" and "warm_start" not in (warm.last_info or {})
    H2 = H * 1.02
    q2 = -H2 @ (x_tgt * 0.98)
    x2w, s2 = warm.solve_quadratic(np.zeros(n), H2, q2)
    assert s2 == "optimal" and warm.last_info.get("warm_start") is True
    cold = QuadBarrierSolver(A=A, b=b, psd_maps=[], psd_eps=1e-6, n=n, device="cpu")
    x2c, s2c = cold.solve_quadratic(np.zeros(n), H2, q2)
    assert s2c == "optimal"
    assert np.linalg.norm(x2w - x2c) < 1e-5
    assert warm.last_info["max_violation"] <= 0.0
    assert warm.last_info["gap_rel"] < 1e-5
    q3 = -H @ np.full(n, -0.8)
    x3, s3 = warm.solve_quadratic(np.zeros(n), H, q3)
    assert s3 == "optimal"
    x3c, _ = cold.solve_quadratic(np.zeros(n), H, q3)
    assert np.linalg.norm(x3 - x3c) < 1e-5


def test_stopped_status_not_stale():
    solver = QuadBarrierSolver(A=None, b=None, psd_maps=[lambda x: x[0].reshape(1, 1)],
                               psd_eps=1e-3, n=1, device="cpu")
    H, q = np.array([[2.0]]), np.array([-4.0])
    x, status = solver.solve_quadratic(np.array([1.0]), H, q)
    assert status == "optimal" and solver.last_info["status"] == "optimal"
    x2, status2 = solver.minimize(np.array([1.0]), H, q, stop_fn=lambda _x: True)
    assert status2 == "stopped" and solver.last_info["status"] == "stopped"


def test_stress_certificate_truthful():
    """Port of tests/test_sdp.py::test_conic_stress_certificate_truthful:
    a starved Newton budget must never report 'optimal'."""
    rng = np.random.default_rng(5)
    n = 12
    U = np.linalg.qr(rng.normal(size=(n, n)))[0]
    H = U @ np.diag(np.logspace(0, -10, n)) @ U.T
    H = (H + H.T) / 2 + 1e-12 * np.eye(n)
    x_tgt = rng.normal(0, 10.0, n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.full(2 * n, 0.05)
    solver = QuadBarrierSolver(A=A, b=b, psd_maps=[], psd_eps=1e-6, n=n, device="cpu")
    x, status = solver.minimize(np.full(n, 0.045), H, -H @ x_tgt,
                                const=float(0.5 * x_tgt @ H @ x_tgt), max_newton=1)
    info = solver.last_info
    assert status in ("optimal_inexact", "max_iter") and info["status"] == status
    assert info["newton_lambda"] >= 0.25 or info["cert_gap_rel"] >= 1e-3
    assert np.all(A @ x - b < 0.0) and info["max_violation"] <= 0.0


def test_geometric_mode_is_not_ported(tmp_path):
    urdf = str(tmp_path / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + ".regressor.npz", urdf + ".regressor.npz")
    rng = np.random.default_rng(3)
    n, nd = 300, 7
    samples = dict(positions=rng.uniform(-1, 1, (n, nd)), velocities=rng.standard_normal((n, nd)),
                   accelerations=rng.standard_normal((n, nd)), torques=rng.standard_normal((n, nd)),
                   times=np.arange(n) / 200.0, frequency=np.array(200.0))
    idf = Identification(sdp_opt(cadRegularizationMode="geometric"), urdf, device="cpu")
    idf.data.init_from_data(samples)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idf.estimateParameters()
