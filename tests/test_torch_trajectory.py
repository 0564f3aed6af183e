"""The port's excitation trajectories and D-optimality objective against
the JAX package, on the CPU in f64 (the optimizer: test_torch_optimizer.py).

Inputs come from numpy seeds and go through both packages. The JAX
objectives are built once per module (their compiles dominate), on small
sizes: the 7-DOF arm with friction and Stribeck columns and capsule
collision constraints at 125 samples and 2 harmonics a joint, and a
2-DOF suspended floating-base model on a 20-sample horizon.

Tolerances. `fourier_traj` (both modes, ragged harmonics, one vector and
a population): 1e-12 absolute. The objective's raw outputs, `evaluate`,
`evaluate_batch`: 1e-8 relative (measured ~1e-15); the gradients of the
penalized value and of the augmented-Lagrangian value against `jax.grad`:
1e-8 relative (measured ~1e-15).
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.collision import CollisionModel as JaxCollisionModel
from flobaroid_tpu.excitation import optimizer as jopt
from flobaroid_tpu.excitation import trajectory as jtraj
from flobaroid_tpu.excitation.objective import TrajectoryObjective as JaxObjective
from flobaroid_tpu.model import Model as JaxModel
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.collision import CollisionModel
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.excitation import trajectory as ttraj
from flobaroid_tpu_torch.excitation.objective import TrajectoryObjective
from flobaroid_tpu_torch.model import Model

from test_trajectory import SUSPENDED_URDF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ----------------------------------------------------------------------
# module 1: trajectory families
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bounded", [False, True], ids=["classic", "tanh_bounded"])
def test_fourier_traj_matches_jax(bounded):
    """Ragged harmonics (3, 1, 4, 2): one vector gives (N, n), a
    population (K, dim) gives (K, N, n); 1e-12."""
    rng = np.random.default_rng(0)
    nf = (3, 1, 4, 2)
    limits = ((-1.0, 1.2), (-2.0, 0.5), (-1.5, 1.5), (-0.4, 0.3)) if bounded else None
    jspec, tspec = jtraj.FourierSpec(nf=nf, limits=limits), ttraj.FourierSpec(nf=nf, limits=limits)
    assert tspec.dim == jspec.dim == 1 + 4 + 2 * 10
    X = rng.standard_normal((5, tspec.dim)) * 0.4
    X[:, 0] = rng.uniform(0.6, 1.8, 5)
    X[3, 1:5] = [2.0, -3.0, 0.0, 0.5]  # centres pushed onto the limits (the clip branch)
    t = np.linspace(0.0, 7.0, 57)
    got = ttraj.fourier_traj(tspec, torch.as_tensor(X), t)
    assert all(a.shape == (5, 57, 4) for a in got)
    for k in range(5):
        want = jtraj.fourier_traj(jspec, jnp.asarray(X[k]), t)
        one = ttraj.fourier_traj(tspec, torch.as_tensor(X[k]), t)
        for g, o, w in zip(got, one, want):
            assert np.abs(g[k].numpy() - np.asarray(w)).max() <= 1e-12
            assert np.abs(o.numpy() - np.asarray(w)).max() <= 1e-12
    for sa, sb in zip(tspec.ragged(X[0])[2:], jspec.ragged(X[0])[2:]):
        assert all(np.array_equal(a, b) for a, b in zip(sa, sb))


def test_fourier_traj_gradient_matches_jax():
    """d(sum of Q + V + A)/dx, also where q0 = 0 ties the range's min()."""
    nf = (2, 3)
    limits = ((-1.0, 1.0), (-0.5, 1.5))
    jspec, tspec = jtraj.FourierSpec(nf=nf, limits=limits), ttraj.FourierSpec(nf=nf, limits=limits)
    x = np.random.default_rng(1).standard_normal(tspec.dim) * 0.3
    x[0], x[1] = 0.9, 0.0
    t = np.linspace(0.0, 5.0, 31)
    want = jax.grad(lambda v: sum(jnp.sum(a) for a in jtraj.fourier_traj(jspec, v, t)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    sum(a.sum() for a in ttraj.fourier_traj(tspec, xt, t)).backward()
    assert _rel(xt.grad.numpy(), want) <= 1e-10


def test_trajectory_object_api_matches_jax():
    lim = [(-1.0, 1.0)] * 3
    a = [np.array([0.3, -0.1]), np.array([0.2]), np.array([0.1, 0.2, -0.3])]
    b = [np.array([-0.2, 0.1]), np.array([0.4]), np.array([0.0, 0.1, 0.2])]
    trajs = [mod.PulsedTrajectory(3).initWithParams(a, b, [0.1, -0.2, 0.0], [2, 1, 3], wf=0.8,
                                                    joint_limits=lim) for mod in (jtraj, ttraj)]
    t = np.linspace(0, 6, 25)
    for got, want in zip(trajs[1].sample(t), trajs[0].sample(t)):
        assert np.abs(got - want).max() <= 1e-12
    for tr in trajs:
        tr.setTime(1.3)
    assert abs(trajs[1].getAngle(2) - trajs[0].getAngle(2)) <= 1e-12
    assert abs(trajs[1].getVelocity(0) - trajs[0].getVelocity(0)) <= 1e-12
    assert abs(trajs[1].getAcceleration(1) - trajs[0].getAcceleration(1)) <= 1e-12
    assert trajs[1].getPeriodLength() == trajs[0].getPeriodLength()
    rand = [mod.PulsedTrajectory(4, use_deg=True).initWithRandomParams(np.random.default_rng(5))
            for mod in (jtraj, ttraj)]
    assert np.array_equal(rand[1].x, rand[0].x)
    for got, want in zip(ttraj.minimum_jerk_transition(np.zeros(2), np.array([1.0, -0.5]), 2.0, 50.0),
                         jtraj.minimum_jerk_transition(np.zeros(2), np.array([1.0, -0.5]), 2.0, 50.0)):
        assert np.array_equal(got, want)
    cfg = dict(num_dofs=2, excitationFrequency=20.0, staticPostureTime=0.2, staticPostureMoveTime=1.0)
    fixed = [mod.FixedPositionTrajectory(cfg).initWithAngles([[0.3, -0.2], [0.5, 0.1]])
             for mod in (jtraj, ttraj)]
    for tr in fixed:
        tr.setTime(1.1)
    assert fixed[1].getAngle(0) == fixed[0].getAngle(0)
    assert fixed[1].getPeriodLength() == fixed[0].getPeriodLength()
    assert fixed[1].wait_for_zero_vel(1.1) == fixed[0].wait_for_zero_vel(1.1)


# ----------------------------------------------------------------------
# modules 3-4: the objective and the optimizer, fixed-base arm
# ----------------------------------------------------------------------
ARM_OPT = dict(
    floatingBase=0, useStructuralRegressor=1, randomSamples=400,
    identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1, stribeckVelocity=0.1,
    computeDtype="float64", excitationFrequency=20.0, trajectoryPulseMin=1.0,
    trajectoryPulseMax=2.0, trajectoryDefaultNf=2, trajectoryTargetVelocity=1.5,
    minVelocityConstraint=1, minVelocityPercentage=0.05, minTorqueUtilization=0.02,
    globalOptSize=8, globalOptIterations=1, globalOptRestarts=1, globalOptAmplitudeRepair=0,
    localOptIterations=1, localOptStages=1, localOptRestarts=2, verbose=0,
)


def _pair(urdf, opt, jax_extra=None, torch_extra=None, n_extra=None, **kw):
    """(JAX, port) objectives on one projection (the JAX model's)."""
    jm = JaxModel(dict(opt), urdf)
    tm = Model(dict(opt), urdf, regressor_init=False, device="cpu")
    tm.load_state(state_from_jax_model(jm))
    lims = jm.limits
    limits = tuple((float(lims[j]["lower"]), float(lims[j]["upper"])) for j in jm.jointNames)
    nf = (int(opt["trajectoryDefaultNf"]),) * jm.num_dofs
    jextra = jax_extra(jm) if jax_extra else None
    textra = torch_extra(tm) if torch_extra else None
    n_extra = n_extra(jm) if n_extra else None
    jobj = JaxObjective(jm, opt, jtraj.FourierSpec(nf=nf, limits=limits),
                        extra_constraints_fn=jextra, n_extra_constraints=n_extra,
                        dtype=jnp.float64, **kw)
    tobj = TrajectoryObjective(tm, opt, ttraj.FourierSpec(nf=nf, limits=limits),
                               extra_constraints_fn=textra, n_extra_constraints=n_extra,
                               dtype=torch.float64, **kw)
    rng = np.random.default_rng(0)
    x0 = jopt.initial_candidate(jobj.spec, opt, rng)
    assert tobj.calibrate_scale(x0) == pytest.approx(jobj.calibrate_scale(x0), rel=1e-12)
    lo, hi = jopt.build_bounds(jobj.spec, opt)
    X = x0 * (1 + 0.15 * rng.standard_normal((4, x0.size)))
    # X[0] keeps the initial candidate's q0 = 0, where min(center - lo,
    # hi - center) ties for symmetric limits (the even split of the
    # subgradient is part of what is compared); the others move off it
    nd = jm.num_dofs
    X[1:, 1:1 + nd] += 0.05 * rng.standard_normal((3, nd))
    X = np.clip(X, lo, hi)
    m = jobj.evaluate(x0)[1].size
    return SimpleNamespace(jobj=jobj, tobj=tobj, opt=opt, x0=x0, X=X, lo=lo, hi=hi,
                           LAM=np.abs(rng.standard_normal((4, m))),
                           RHO=np.array([10.0, 40.0, 10.0, 160.0]))


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """The arm with friction, Stribeck columns, velocity and torque
    floors and the capsule collision constraint with min-jerk ramps."""
    d = tmp_path_factory.mktemp("torch_traj_arm")
    urdf = str(d / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    opt = load_config(None, overrides=ARM_OPT)

    def jax_extra(m):
        return JaxCollisionModel(m.tree, m.engine, opt).trajectory_constraint_fn(3, 4)

    def torch_extra(m):
        return CollisionModel(m.tree, m.engine, opt).trajectory_constraint_fn(3, 4)

    return _pair(urdf, opt, jax_extra, torch_extra,
                 n_extra=lambda m: JaxCollisionModel(m.tree, m.engine, opt).num_pairs)


@pytest.fixture(scope="module")
def suspended(tmp_path_factory):
    """A 2-DOF floating base hanging from `crane_ft`: the ball-joint
    integrator inside the chain, on a 20-sample horizon."""
    d = tmp_path_factory.mktemp("torch_traj_suspended")
    urdf = d / "susp.urdf"
    urdf.write_text(SUSPENDED_URDF)
    opt = load_config(None, overrides=dict(
        floatingBase=1, floatingBaseAttachment="suspended",
        floatingBaseAttachmentFrame="crane_ft", suspendedDamping=50.0,
        useStructuralRegressor=1, randomSamples=400, computeDtype="float64",
        excitationFrequency=20.0, trajectoryPulseMin=1.0, trajectoryPulseMax=2.0,
        trajectoryDefaultNf=2, trajectoryTargetVelocity=0.8, verbose=0))
    return _pair(str(urdf), opt, duration=1.0)


def _jax_al(jobj):
    def al(x, lam, rho):
        f, g, _ = jobj._evaluate(x, jobj.dopt_scale, jobj._shift_j)
        t = jnp.maximum(0.0, lam + rho * g)
        return f + (0.5 / rho) * jnp.sum(t**2 - lam**2)

    return jax.jit(jax.vmap(jax.value_and_grad(al)))


@pytest.mark.timeout(180)
@pytest.mark.parametrize("case", ["arm", "suspended"])
def test_objective_values_match_jax(case, request):
    """The chain's raw outputs, `evaluate`, `evaluate_batch`, `dopt`."""
    p = request.getfixturevalue(case)
    jf, jg, jn = p.jobj.evaluate_batch(p.X)
    tf, tg, tn = p.tobj.evaluate_batch(p.X)
    assert tg.shape == jg.shape and np.all(np.isfinite(tf))
    assert _rel(tf, jf) <= 1e-8 and _rel(tg, jg) <= 1e-8 and np.array_equal(tn, jn)
    f1, g1, n1 = p.tobj.evaluate(p.X[1])
    assert abs(f1 - jf[1]) <= 1e-8 * abs(jf[1]) and _rel(g1, jg[1]) <= 1e-8 and n1 == jn[1]
    raw_j = p.jobj._raw_jit(jnp.asarray(p.X[2]), p.jobj._shift_j)
    with torch.no_grad():
        raw_t = p.tobj._raw(torch.as_tensor(p.X[2:3]), p.tobj._shift_t)
    for want, got in zip(raw_j, raw_t):
        assert _rel(got[0].numpy(), want) <= 1e-8 or abs(float(want)) == 0.0 == float(got[0])
    assert bool(raw_t[7][0])
    assert abs(p.tobj.dopt(p.X[2]) - p.jobj.dopt(p.X[2])) <= 1e-8 * abs(p.jobj.dopt(p.X[2]))
    assert p.tobj.feasible(tg[0]) == p.jobj.feasible(jg[0])
    if case == "arm":
        # the constraint shift of the mesh recovery moves the collision block only
        shift = np.linspace(0.0, 0.1, 15)
        for o in (p.jobj, p.tobj):
            o.set_extra_shift(shift)
        try:
            sj, st = p.jobj.evaluate(p.X[0])[1], p.tobj.evaluate(p.X[0])[1]
        finally:
            for o in (p.jobj, p.tobj):
                o.set_extra_shift(np.zeros(15))
        assert _rel(st, sj) <= 1e-8 and np.abs((st - tg[0])[-15:] - shift).max() <= 1e-12
    else:
        Q, BR, BP = p.tobj.kinematics(p.X[0])
        Qj, BRj, BPj = p.jobj.kinematics(p.X[0])
        assert _rel(Q, Qj) <= 1e-10 and _rel(BR, BRj) <= 1e-10 and _rel(BP, BPj) <= 1e-9


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", ["arm", "suspended"])
def test_gradients_match_jax(case, request):
    """The gradient of the augmented-Lagrangian value of four candidates
    with their own multipliers, and of the penalized value, against
    jax.grad: 1e-8 relative."""
    p = request.getfixturevalue(case)
    jv, jg = _jax_al(p.jobj)(jnp.asarray(p.X), jnp.asarray(p.LAM), jnp.asarray(p.RHO))
    tv, tg = p.tobj.al_value_and_grad(p.X, p.LAM, p.RHO)
    assert _rel(tv, jv) <= 1e-8
    for k in range(4):
        assert _rel(tg[k], jg[k]) <= 1e-8, k
        assert np.linalg.norm(tg[k]) > 0
    jv, jg = p.jobj.penalized_value_and_grad(p.X[2], 10.0)
    tv, tg = p.tobj.penalized_value_and_grad(p.X[2], 10.0)
    assert abs(tv - jv) <= 1e-8 * abs(jv) and _rel(tg, jg) <= 1e-8


def test_failed_cholesky_reads_1e4_and_spares_the_batch(arm):
    """A candidate whose Gram has no Cholesky factor reads f = 1e4 (the
    JAX chain's NaN rule) with a zero gradient; the others of the batch
    keep their values and finite gradients."""
    tobj = arm.tobj
    ref_f, _, _ = tobj.evaluate_batch(arm.X)
    ref_v, ref_g = tobj.al_value_and_grad(arm.X, arm.LAM, arm.RHO)
    nb = tobj.Pb.shape[1]
    bad = -1e9 * np.eye(nb)
    assert tobj.yty_prior is None
    orig = tobj._raw

    def raw_with_bad_candidate(X, shift):
        out = list(orig(X, shift))
        # recompute candidate 1's factorization on an indefinite matrix
        _, info = torch.linalg.cholesky_ex(torch.as_tensor(bad))
        ok = out[7].clone()
        ok[1] = info == 0
        out[7] = ok
        return tuple(out)

    tobj._raw = raw_with_bad_candidate
    try:
        f, g, _ = tobj.evaluate_batch(arm.X)
        v, grad = tobj.al_value_and_grad(arm.X, arm.LAM, arm.RHO)
    finally:
        tobj._raw = orig
    assert f[1] == 1e4 and np.all(grad[1] == 0)
    keep = [0, 2, 3]
    assert np.array_equal(f[keep], ref_f[keep]) and np.array_equal(grad[keep], ref_g[keep])
    assert np.all(np.isfinite(grad)) and np.all(np.isfinite(v))


def test_infinite_limits_stay_satisfied(tmp_path):
    """A joint without a velocity limit gives vel_absmax - inf = -inf: it
    must read as satisfied (-1e6), leak no NaN into the gradient, and
    agree with the JAX package."""
    urdf = tmp_path / "arm_nolimit.urdf"
    text = open(ARM_URDF).read()
    assert 'velocity="' in text
    import re

    urdf.write_text(re.sub(r' velocity="[^"]*"', "", text, count=2))
    opt = load_config(None, overrides=dict(ARM_OPT, checkCollisions=0, stribeckVelocity=0,
                                           minVelocityConstraint=0, trajectoryTargetVelocity=0.0))
    p = _pair(str(urdf), opt)
    assert np.isinf(p.tobj.vel_lim).sum() == 2
    jf, jg, _ = p.jobj.evaluate_batch(p.X)
    tf, tg, _ = p.tobj.evaluate_batch(p.X)
    assert (tg == -1e6).sum() == 2 * len(p.X) and np.array_equal(tg == -1e6, jg == -1e6)
    assert _rel(tf, jf) <= 1e-8 and _rel(tg, jg) <= 1e-8
    m = tg.shape[1]
    v, grad = p.tobj.al_value_and_grad(p.X, p.LAM[:, :m], p.RHO)
    jv, jgrad = _jax_al(p.jobj)(jnp.asarray(p.X), jnp.asarray(p.LAM[:, :m]), jnp.asarray(p.RHO))
    assert np.all(np.isfinite(grad)) and _rel(grad, jgrad) <= 1e-8 and _rel(v, jv) <= 1e-8
