"""The port's geometric (log-det) SDP and CAD-regularization study
against the JAX package, on the CPU in f64.

Solver level, on the 7-DOF arm (800 noisy samples, numpy seed 21, the
checked-in structural cache so both packages use one projection): the
program the geometric identify hands to `conic.solve` is recorded in
both packages and solved afresh by both; the objective's closed-form
gradient and Hessian are held against jax.grad / jax.hessian of the JAX
closure, also where a link's whitened pseudo-inertia Q is indefinite.
Study level, on humanoid30 (the checked-in suspended recording at
skipSamples=1, 1000 samples, P = 430): `run_cad_study` of both packages.

Tolerances. The geometric prior is strictly convex in the regularized
links, so unlike the quadratic modes (xStd unique only in its base
directions, held at 1e-3 in test_torch_pipeline.py) the whole of x* is
unique: both solvers follow the same ladder (mu = 60, the same Newton
and line-search rules) and agree to 1e-8 relative in x, xBase and xStd
on the arm (measured ~1e-12 to 1e-15: rounding order only; the solvers'
own stopping gap, gap_rel 7.7e-8, bounds the objective, not the
distance between two runs of one algorithm). The study's distances
agree to 1e-8 relative (measured ~1e-12).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flobaroid_tpu.identification.conic as jconic
from flobaroid_tpu.identification import cad_study as jcad
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.utils import helpers as jhelpers
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.identification import cad_study, conic
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.utils import helpers

from test_identification import synth_samples

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
H30_REAL = os.path.join(REPO, "examples", "models", "humanoid30_real.urdf")
H30_MEAS = os.path.join(REPO, "examples", "data", "humanoid30_suspended_cad.npz")
# the JAX package's base distances of record (BENCH_r05), uniform /
# observability / geometric / geometric_obs
BENCH_BASE_DIST = dict(uniform=1.786, observability=1.551, geometric=1.432, geometric_obs=1.431)


def geo_opt(**kw):
    return load_config(None, overrides={**dict(
        verbose=0, floatingBase=0, useStructuralRegressor=1, randomSamples=600,
        computeDtype="float64", estimateWith="std", materializeRegressor=0,
        constrainToConsistent=1, limitOverallMass=1, limitMassRange=1.0,
        limitMassToApriori=1, limitMassAprioriBoundary=0.3,
        cadRegularizationMode="geometric"), **kw})


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cad_arm")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz"):
        shutil.copy(f, d)
    urdf = str(d / "sevenlink_arm.urdf")
    samples, _ = synth_samples(urdf, n=800, noise=0.05, seed=21)
    return urdf, samples


def _identify_pair(urdf, samples, **kw):
    jidf = JaxIdentification(geo_opt(**kw), urdf)
    tidf = Identification(geo_opt(**kw), urdf, device="cpu")
    tidf.model.load_state(state_from_jax_model(jidf.model))
    for idf in (jidf, tidf):
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
    return jidf, tidf


@pytest.fixture(scope="module")
def programs(arm):
    """(JAX, port) geometric identifies of the arm, with the program and
    start point each handed to its package's `conic.solve`."""
    recorded = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("jax", jconic), ("torch", conic)):
            orig = mod.solve

            def record(prob, x0, *a, _orig=orig, _name=name, **kw):
                recorded[_name] = (prob, np.array(x0))
                return _orig(prob, x0, *a, **kw)

            mp.setattr(mod, "solve", record)
        jidf, tidf = _identify_pair(*arm)
    return jidf, tidf, recorded["jax"], recorded["torch"]


def test_geometric_identification_matches_jax(programs):
    jidf, tidf, _, _ = programs
    assert tidf.sdp.last_status == jidf.sdp.last_status == "optimal"
    assert _rel(tidf.model.xBase, jidf.model.xBase) <= 1e-8
    assert _rel(tidf.model.xStd, jidf.model.xStd) <= 1e-8
    assert abs(tidf.res_error - jidf.res_error) <= 1e-8 * jidf.res_error
    ti, ji = tidf.sdp.last_info, jidf.sdp.last_info
    assert ti["status"] == ji["status"] == "optimal"
    assert ti["barrier_t"] == ji["barrier_t"] and ti["max_violation"] <= 0.0
    assert ti["newton_iters"] > 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize("variant", ["observability_weighted_apriori", "materialized"])
def test_geometric_variants_match_jax(arm, variant):
    """geometricObservabilityWeighting with the streamed residual scale in
    a-priori-error space, and the materialized residual scale (from
    YBase)."""
    kw = dict(observability_weighted_apriori=dict(geometricObservabilityWeighting=1,
                                                  useAPriori=1),
              materialized=dict(materializeRegressor=1))[variant]
    jidf, tidf = _identify_pair(*arm, **kw)
    assert tidf.sdp.last_status == jidf.sdp.last_status == "optimal"
    assert _rel(tidf.model.xBase, jidf.model.xBase) <= 1e-8
    assert _rel(tidf.model.xStd, jidf.model.xStd) <= 1e-8


def test_conic_solve_matches_jax(programs):
    """Fresh `conic.solve` of both packages on the recorded program: the
    same point, objective value and status; the port's torch.func route
    (no closed-form derivatives) lands on the same point too."""
    _, _, (jprob, x0), (tprob, x0t) = programs
    assert np.array_equal(x0, x0t)
    ji, ti, ai = {}, {}, {}
    xj, sj = jconic.solve(jprob, x0, info=ji)
    xt, st = conic.solve(tprob, x0, info=ti, device="cpu")
    assert st == sj == "optimal" and ti["status"] == ji["status"] == "optimal"
    assert _rel(xt, xj) <= 1e-8
    fj = float(jprob.objective(jnp.asarray(xj)))
    ft = float(tprob.objective(torch.tensor(xt)))
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    for k in ("gap_rel", "cert_gap_rel", "barrier_t"):
        assert ti[k] == pytest.approx(ji[k], rel=1e-6), k
    auto = conic.BarrierProblem(objective=tprob.objective, A=tprob.A, b=tprob.b,
                                psd_maps=tprob.psd_maps, psd_eps=tprob.psd_eps)
    xa, sa = conic.solve(auto, x0, info=ai, device="cpu")
    assert sa == "optimal" and _rel(xa, xt) <= 1e-8


def _indefinite_points(tprob, x0):
    """x0, a perturbed point, and two points where the first regularized
    link's whitened pseudo-inertia is indefinite: one negative eigenvalue
    (det < 0) and two (det > 0)."""
    cols = tprob.objective.idx[0].numpy()  # m, h(3), ixx ixy ixz iyy iyz izz
    rng = np.random.default_rng(4)
    pts = {"apriori": x0, "perturbed": x0 * (1 + 0.05 * rng.standard_normal(x0.size))}
    one = x0.copy()
    one[cols[4]] = x0[cols[7]] + x0[cols[9]] + 1.0  # Ixx > Iyy + Izz
    two = x0.copy()
    two[cols[4]] = two[cols[7]] = 1.0
    two[cols[9]] = -1.0  # Sigma_xx = Sigma_yy = -0.5
    pts.update(det_negative=one, two_negative_eigenvalues=two)
    return pts


@pytest.mark.timeout(120)
def test_geometric_objective_and_derivatives_match_jax(programs):
    """Value, gradient and Hessian of the port's closed form against the
    JAX closure and its jax.grad / jax.hessian, at regular points and
    where Q is indefinite: det Q <= 0 reads 1e6 with zero gradient, an
    indefinite Q with det > 0 reads tr - log|det| - 4 (the JAX rule)."""
    _, _, (jprob, x0), (tprob, _) = programs
    obj = tprob.objective
    jgrad, jhess = jax.jit(jax.grad(jprob.objective)), jax.jit(jax.hessian(jprob.objective))
    pts = _indefinite_points(tprob, x0)
    Q = obj._Q(torch.tensor(np.stack([pts["det_negative"], pts["two_negative_eigenvalues"]])))
    ev = torch.linalg.eigvalsh(Q[:, 0])
    assert (ev[0] < 0).sum() == 1 and (ev[1] < 0).sum() == 2
    for name, x in pts.items():
        fj = float(jprob.objective(jnp.asarray(x)))
        ft = float(obj(torch.tensor(x)))
        # the residual part is a difference of O(|d|) terms, squared
        assert abs(ft - fj) <= 1e-12 * max(abs(fj), float(obj.d @ obj.d)), name
        g, H = obj.grad_hess(torch.tensor(x))
        gj, Hj = np.asarray(jgrad(jnp.asarray(x))), np.asarray(jhess(jnp.asarray(x)))
        assert np.abs(g.numpy() - gj).max() <= 1e-9 * np.abs(gj).max(), name
        assert np.abs(H.numpy() - Hj).max() <= 1e-9 * np.abs(Hj).max(), name
    # the penalty is a constant: 1e6 * the link's weight above the rest
    x = pts["det_negative"]
    assert float(obj(torch.tensor(x))) > 1e6 * float(obj.w[0]) * 0.999
    # a batch of points in one call, as the line search evaluates it
    batch = torch.tensor(np.stack(list(pts.values())))
    assert torch.allclose(obj(batch), torch.stack([obj(b) for b in batch]), rtol=1e-12, atol=0)


@pytest.mark.timeout(120)
def test_phase1_from_an_infeasible_start_matches_jax(programs):
    """The module-level phase-I on a start with a negative mass: both
    packages reach a strictly feasible point (the same one: the ladder
    stops at the first strictly feasible stage), and the port's `solve`
    from the infeasible start ends optimal at a strictly feasible point
    (its gap test is anchored to the objective at the phase-I point, far
    from the a-priori one, so the point differs from the a-priori
    start's)."""
    _, _, (jprob, x0), (tprob, _) = programs
    bad = x0.copy()
    cols = tprob.objective.idx[1].numpy()
    bad[cols[0]] = -0.5 * x0[cols[0]]
    core = conic._BarrierCore(tprob.A, tprob.b, conic.stack_affine_psd(tprob.psd_maps, x0.size),
                              tprob.psd_eps, x0.size, torch.device("cpu"))
    assert float(core.feas_slack(torch.tensor(bad))) > 0
    xj, okj = jconic.phase1(jprob, bad)
    xt, okt = conic.phase1(tprob, bad, device="cpu")
    assert okt and okj
    assert float(core.feas_slack(torch.tensor(xt))) < 0
    assert _rel(xt, xj) <= 1e-6
    feasible, ok = conic.phase1(tprob, x0, device="cpu")
    assert ok and np.array_equal(feasible, x0)  # already feasible: returned as is
    ti = {}
    x, status = conic.solve(tprob, bad, info=ti, device="cpu")
    assert status == ti["status"] and status.startswith("optimal")
    assert ti["max_violation"] <= 0.0 and float(core.feas_slack(torch.tensor(x))) < 0
    assert float(tprob.objective(torch.tensor(x))) < float(tprob.objective(torch.tensor(xt)))


def test_barrier_minimize_statuses():
    """'infeasible_start' from a point outside the cone, 'stopped' from a
    stop function, 'infeasible' from `solve` on an empty feasible set."""
    prob = conic.BarrierProblem(
        objective=lambda x: ((x - 2.0) ** 2).sum(dim=-1),
        A=np.array([[1.0, 0.0], [0.0, 1.0]]), b=np.array([1.0, 1.0]),
        psd_maps=[lambda x: np.diag(x[:2])], psd_eps=1e-3)
    info = {}
    _, status = conic.barrier_minimize(prob, np.array([-1.0, 0.5]), info=info, device="cpu")
    assert status == info["status"] == "infeasible_start"
    _, status = conic.barrier_minimize(prob, np.array([0.5, 0.5]), info=info,
                                       stop_fn=lambda x: True, device="cpu")
    assert status == info["status"] == "stopped"
    x, status = conic.solve(prob, np.array([-1.0, 3.0]), info=info, device="cpu")
    assert status == "optimal" and np.allclose(x, 1.0, atol=1e-4)  # both bounds active
    empty = conic.BarrierProblem(
        objective=prob.objective, A=np.array([[1.0, 0.0], [-1.0, 0.0]]),
        b=np.array([-1.0, -1.0]))  # x0 <= -1 and x0 >= 1
    _, status = conic.solve(empty, np.zeros(2), info=info, device="cpu")
    assert status == info["status"] == "infeasible"


# ----------------------------------------------------------------------
# the study on humanoid30
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """The JAX study (the two geometric modes) and the port's (all four
    modes, twice on one Identification) on copies of the checked-in
    models, structural cache and recording; the port's regressor passes
    are counted."""
    d = tmp_path_factory.mktemp("torch_cad_study")
    for f in (H30_URDF, H30_URDF + ".regressor.npz", H30_REAL, H30_MEAS):
        shutil.copy(f, d)
    cad, real, meas = (str(d / os.path.basename(f)) for f in (H30_URDF, H30_REAL, H30_MEAS))
    over = dict(skipSamples=1, computeDtype="float64")
    geo = {k: jcad.MODE_OVERRIDES[k] for k in ("geometric", "geometric_obs")}
    jres = jcad.run_cad_study(cad, real, meas, base_overrides=over, modes=geo)
    passes = []
    orig = Model.computeRegressors
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, "computeRegressors",
                   lambda self, *a, **kw: (passes.append(1), orig(self, *a, **kw))[1])
        idf = cad_study.study_identification(cad, real, meas, over, device="cpu")
        cold = cad_study.run_cad_study(cad, real, meas, idf=idf)
        n_cold = len(passes)
        warm = cad_study.run_cad_study(cad, real, meas, idf=idf)
    return dict(jax=jres, cold=cold, warm=warm, passes=(n_cold, len(passes) - n_cold), idf=idf)


@pytest.mark.parametrize("mode", ["geometric", "geometric_obs"])
def test_cad_study_matches_jax(studies, mode):
    j, t = studies["jax"][mode], studies["cold"][mode]
    assert t["status"] == j["status"] == "optimal"
    for k in ("base_dist", "std_dist", "res_error_pct"):
        assert t[k] == pytest.approx(j[k], rel=1e-8), k
    for k in ("base_dist", "std_dist"):
        assert studies["cold"]["apriori"][k] == pytest.approx(studies["jax"]["apriori"][k], rel=1e-12)


def test_cad_study_reproduces_the_ordering_of_record(studies):
    """All four modes optimal with a residual under 5 %
    (tests/test_cad_quality.py), bench.py's ordering, and base distances
    within 3 % of the JAX package's (measured: within 0.1 %)."""
    for res in (studies["cold"], studies["warm"]):
        b = {m: res[m]["base_dist"] for m in cad_study.MODE_OVERRIDES}
        for m in cad_study.MODE_OVERRIDES:
            assert res[m]["status"].startswith("optimal") and res[m]["res_error_pct"] < 5.0
            assert abs(b[m] / BENCH_BASE_DIST[m] - 1) <= 0.03, (m, b[m])
        assert b["uniform"] > b["observability"] > 0.98 * b["geometric"]
        assert abs(b["geometric"] - b["geometric_obs"]) < 0.15 * b["geometric"]
        assert b["geometric"] < res["apriori"]["base_dist"]


def test_cad_study_makes_one_regressor_pass_and_rewarms(studies):
    """One Identification serves the four modes: one regressor pass per
    study, not one per mode; a second study on it lands on the same base
    distances (the geometric modes restart cold, the quadratic ones from
    the solver's warm start)."""
    assert studies["passes"] == (1, 1)
    for m in cad_study.MODE_OVERRIDES:
        assert studies["warm"][m]["base_dist"] == pytest.approx(
            studies["cold"][m]["base_dist"], rel=1e-5), m
        assert studies["cold"][m]["newton_iters"] > 0 and studies["cold"][m]["sdp_s"] > 0
    assert set(studies["idf"].stage_times) == {"regressor_gram", "ols_wls", "sdp", "reporting"}


def test_format_table_matches_jax(studies):
    assert cad_study.format_table(studies["cold"]) == jcad.format_table(studies["cold"])
    assert cad_study.MODE_OVERRIDES == jcad.MODE_OVERRIDES
    assert list(cad_study.MODE_OVERRIDES) == list(jcad.MODE_OVERRIDES)


def test_make_perturbed_real_urdf_matches_jax(tmp_path):
    """The same seed gives a byte-equal URDF and the same distance."""
    outs = []
    for name, mod in (("jax", jcad), ("torch", cad_study)):
        out = tmp_path / f"{name}_real.urdf"
        outs.append((out, mod.make_perturbed_real_urdf(H30_URDF, str(out), noise=0.08, seed=3)))
    (pj, dj), (pt, dt) = outs
    assert dt == dj and 0.05 < dt < 0.2
    assert pt.read_bytes() == pj.read_bytes()
    assert pt.read_bytes() != open(H30_URDF, "rb").read()


def test_generate_suspended_measurements_is_not_ported(tmp_path):
    """The study's last entry point is ported (the name is kept from when
    it raised): a 2 s recording of the suspended real model has the
    measurement keys, 100 finite samples of 36 torque rows, a swinging
    base, and is what the npz on disk holds. Value parity with the JAX
    package: test_torch_simulation.py."""
    from flobaroid_tpu_torch.simulation.simulator import MEASUREMENT_KEYS

    out = tmp_path / "m.npz"
    meas = cad_study.generate_suspended_measurements(H30_REAL, str(out), duration=2.0, seed=1,
                                                     device="cpu")
    assert set(meas) == MEASUREMENT_KEYS
    assert meas["torques"].shape == (100, 36) and meas["positions"].shape == (100, 30)
    assert all(np.all(np.isfinite(np.asarray(meas[k], dtype=float)))
               for k in MEASUREMENT_KEYS - {"contacts"})
    assert np.abs(meas["base_rpy"]).max() > 1e-3 and np.abs(meas["base_position"]).max() > 0.1
    with np.load(out, allow_pickle=True) as f:
        assert set(f.files) == MEASUREMENT_KEYS and np.array_equal(f["torques"], meas["torques"])
    with pytest.MonkeyPatch.context() as m:  # the default device is the card: no CPU fallback
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cad_study.generate_suspended_measurements(H30_REAL, str(out), duration=2.0)


@pytest.mark.parametrize("triangle", [False, True], ids=["spatial_6x6", "pseudo_inertia_4x4"])
def test_physical_consistency_helpers_match_jax(triangle):
    """pseudo_inertia and is_physical_consistent on the arm's parameters,
    perturbed (consistent) and with one link's inertia made indefinite."""
    from flobaroid_tpu_torch.models.urdf import load_urdf

    tree = load_urdf(ARM_URDF)
    pi = tree.std_params()
    rng = np.random.default_rng(6)
    cases = [pi, pi * (1 + 0.05 * rng.standard_normal(pi.shape))]
    bad = pi.copy()
    bad[24] = bad[27] + bad[29] + 1.0  # link 2: Ixx > Iyy + Izz breaks the triangle inequality
    worse = pi.copy()
    worse[24] = -1.0
    cases += [bad, worse]
    got = [helpers.is_physical_consistent(p, tree.num_links, triangle=triangle) for p in cases]
    assert got == [jhelpers.is_physical_consistent(p, tree.num_links, triangle=triangle)
                   for p in cases]
    assert got[0] and not got[3] and got[2] == (not triangle)
    for p in cases:
        assert np.array_equal(helpers.pseudo_inertia(p[20:30]), jhelpers.pseudo_inertia(p[20:30]))
