"""The port's suspended-base integrator, measurement effects and
simulator against the JAX package, on the CPU in f64.

Inputs come from numpy seeds and go through both packages. Tolerances:
the suspended-base series (`simulate`, the equilibrium search, the
attachment inertia) 1e-9 absolute (measured ~1e-16 on motions inside the
swing limit); each smooth effect 1e-12 relative to the effect's largest
magnitude; the quantizing effects may differ by one quantum in at most 2
entries (a value within rounding of a tie) and by nothing larger; the
simulator's output key by key: exact for what is pure numpy, 1e-9
relative for what passed through the device (torques, positions, the
base series; the filter chain and the noise draws are numpy's in both).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simulator as jax_simulator
from flobaroid_tpu.excitation import suspended as jsus
from flobaroid_tpu.identification import cad_study as jcad
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu.simulation import effects as jfx
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.excitation import suspended as tsus
from flobaroid_tpu_torch.identification import cad_study
from flobaroid_tpu_torch.models.urdf import load_urdf
from flobaroid_tpu_torch.simulation import effects as tfx
from flobaroid_tpu_torch.simulation import simulator

from test_mimic import MIMIC_URDF
from test_simulation import PENDULUM_URDF
from test_trajectory import SUSPENDED_URDF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
H30_REAL = os.path.join(REPO, "examples", "models", "humanoid30_real.urdf")


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def _write(tmp_path_factory, name, text):
    p = tmp_path_factory.mktemp("torch_sim") / f"{name}.urdf"
    p.write_text(text)
    return str(p)


def _multisine(rng, N, n, freq, amp=(0.2, 0.6)):
    t = np.arange(N) / freq
    w, ph, a = rng.uniform(1, 4, n), rng.uniform(0, 6, n), rng.uniform(*amp, n)
    arg = w * t[:, None] + ph
    return t, a * np.sin(arg), a * w * np.cos(arg), -a * w * w * np.sin(arg)


# ----------------------------------------------------------------------
# module 5: the suspended base
# ----------------------------------------------------------------------
SIMS = {
    "pendulum": (PENDULUM_URDF, "hook", "body", 5.0),
    "two_dof_crane": (SUSPENDED_URDF, "crane_ft", None, 50.0),
}


@pytest.fixture(scope="module", params=list(SIMS))
def sims(request, tmp_path_factory):
    text, att, bl, damping = SIMS[request.param]
    urdf = _write(tmp_path_factory, request.param, text)
    js = jsus.SuspendedSimulator(jax_load_urdf(urdf), att, base_link=bl, damping=damping)
    ts = tsus.SuspendedSimulator(load_urdf(urdf), att, base_link=bl, damping=damping, device="cpu")
    return js, ts, urdf


def test_euler_map_matches_jax():
    rng = np.random.default_rng(0)
    rpy, om = rng.uniform(-1.2, 1.2, (2, 8, 3))
    E = tsus.euler_map_direct(T(rpy)).numpy()
    rates = tsus.angular_velocity_to_rpy_rates(T(rpy), T(om)).numpy()
    for k in range(8):
        assert np.abs(E[k] - np.asarray(jsus.euler_map_direct(jnp.asarray(rpy[k])))).max() <= 1e-12
        want = jsus.angular_velocity_to_rpy_rates(jnp.asarray(rpy[k]), jnp.asarray(om[k]))
        assert np.abs(rates[k] - np.asarray(want)).max() <= 1e-12


@pytest.mark.timeout(120)
def test_suspended_simulate_matches_jax(sims):
    """300 steps of a multi-sine joint motion from the static equilibrium
    (inside the swing limit): base rpy, velocity, acceleration, position."""
    js, ts, _ = sims
    t, Q, V, A = _multisine(np.random.default_rng(1), 300, js.engine.num_dofs, 100.0)
    want, got = js.simulate(Q, V, A, t), ts.simulate(Q, V, A, t)
    for w, g in zip(want, got):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-9
    assert np.abs(want[0]).max() < np.deg2rad(25) - 0.05 and np.abs(want[0]).max() > 0.01
    eq_j, eq_t = js.find_equilibrium_rpy(Q[0]), ts.find_equilibrium_rpy(Q[0])
    assert np.abs(eq_t - eq_j).max() <= 1e-9 and np.abs(eq_j).max() > 1e-3
    # a population of two trajectories advances as one batch
    with torch.no_grad():
        both = ts.simulate_core(T(np.stack([Q, 0.5 * Q])), T(np.stack([V, 0.5 * V])),
                                T(np.stack([A, 0.5 * A])), T(eq_t), 0.01)
    assert np.abs(both[0][0].numpy() - got[0]).max() <= 1e-12
    assert np.abs(both[2][0].numpy() - got[1]).max() <= 1e-12


def test_locked_attachment_inertia_matches_rnea_and_jax(sims):
    """The closed-form alpha-response matrix equals the three unit-alpha
    RNEA sweeps it replaces (the port's own), and the JAX package's."""
    js, ts, _ = sims
    n = ts.engine.num_dofs
    rng = np.random.default_rng(2)
    q, dq, ddq = (rng.uniform(-s, s, (4, n)) for s in (1.0, 2.0, 5.0))
    att_rpy, att_omega = rng.uniform(-0.3, 0.3, (4, 3)), rng.uniform(-1.0, 1.0, (4, 3))
    R_wr, pw, p_a, s, mask, v_r = ts._root_state(T(q), T(att_rpy), T(att_omega), T(dq))
    n0 = ts._moment_about_attachment(T(q), T(dq), T(ddq), R_wr, v_r, p_a, torch.zeros(4, 3).double(),
                                     s, mask)
    cols = [ts._moment_about_attachment(T(q), T(dq), T(ddq), R_wr, v_r, p_a,
                                        T(np.tile(e, (4, 1))), s, mask) - n0 for e in np.eye(3)]
    A_rnea = torch.stack(cols, dim=-1).numpy()
    A_closed = ts._locked_attachment_inertia(T(q), R_wr, pw, p_a).numpy()
    np.testing.assert_allclose(A_closed, A_rnea, rtol=1e-8, atol=1e-10 * np.abs(A_rnea).max())
    for k in range(4):
        jr = js._root_state(jnp.asarray(q[k]), jnp.asarray(att_rpy[k]), jnp.asarray(att_omega[k]),
                            jnp.asarray(dq[k]))
        A_jax = np.asarray(js._locked_attachment_inertia(jnp.asarray(q[k]), jr[0], jr[1], jr[2]))
        assert np.abs(A_closed[k] - A_jax).max() <= 1e-9
        n0_jax = js._moment_about_attachment(jnp.asarray(q[k]), jnp.asarray(dq[k]),
                                             jnp.asarray(ddq[k]), jr[0], jr[5], jr[2],
                                             jnp.zeros(3), jr[3], jr[4])
        assert np.abs(n0[k].numpy() - np.asarray(n0_jax)).max() <= 1e-9


@pytest.mark.timeout(120)
def test_suspended_bounce_branch(tmp_path_factory):
    """A forced case: with a 5 degree swing limit the pendulum, released
    at zero tilt, swings through its 4.4 degree equilibrium into the
    limit. The attachment angle is clamped there and the bounce reverses
    the motion; up to the first contact the series agree with the JAX
    package at 1e-9, after it (a one-ulp difference may shift a bounce by
    a step) at 1e-6."""
    urdf = _write(tmp_path_factory, "bounce", PENDULUM_URDF)
    kw = dict(base_link="hook", damping=0.05, max_swing_deg=5.0)
    js = jsus.SuspendedSimulator(jax_load_urdf(urdf), "hook", **kw)
    ts = tsus.SuspendedSimulator(load_urdf(urdf), "hook", device="cpu", **kw)
    N = 400
    t = np.arange(N) / 200.0
    Z = np.zeros((N, 1))
    want = js.simulate(Z, Z, Z, t, initial_rpy=np.zeros(3))
    got = ts.simulate(Z, Z, Z, t, initial_rpy=np.zeros(3))
    pitch = -got[0][:, 1]  # base == attachment here; stored rpy is the inverse convention
    lim = np.deg2rad(5.0)
    assert np.abs(got[0]).max() <= lim + 1e-12
    hit = int(np.argmax(np.abs(pitch) >= lim - 1e-12))
    assert 0 < hit < N - 20, "the swing limit was not reached"
    rate = got[1][:, 4]
    assert np.sign(rate[hit + 2]) == -np.sign(rate[hit - 2])  # the bounce reversed it
    for w, g in zip(want, got):
        assert np.abs(g[:hit] - w[:hit]).max() <= 1e-9
        assert np.abs(g - w).max() <= 1e-6


def test_suspended_guards_and_wrapper(tmp_path_factory, monkeypatch):
    mimic = _write(tmp_path_factory, "mimic", MIMIC_URDF)
    with pytest.raises(NotImplementedError, match="mimic"):
        tsus.SuspendedSimulator(load_urdf(mimic), "base", device="cpu")
    pend = _write(tmp_path_factory, "pend", PENDULUM_URDF)
    with pytest.raises(ValueError, match="attachment frame"):
        tsus.SuspendedSimulator(load_urdf(pend), "no_such_link", device="cpu")
    with monkeypatch.context() as m:  # the default device is the card: no CPU fallback
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsus.SuspendedSimulator(load_urdf(pend), "hook")
    t, Q, V, A = _multisine(np.random.default_rng(3), 60, 1, 100.0)
    want = jsus.simulate_suspended_base_motion(pend, Q, V, A, t, attachment_frame="hook",
                                               damping=5.0)
    got = tsus.simulate_suspended_base_motion(pend, Q, V, A, t, attachment_frame="hook",
                                              damping=5.0, device="cpu")
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= 1e-9
    v = np.random.default_rng(4).standard_normal((9, 6))
    assert np.abs(tsus.SuspendedSimulator.acceleration_from_velocity(T(v), 0.02).numpy()
                  - np.asarray(jsus.SuspendedSimulator.acceleration_from_velocity(
                      jnp.asarray(v), 0.02))).max() <= 1e-12


# ----------------------------------------------------------------------
# module 6: the effects
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def arm_fx():
    jp_j = jfx.JointProperties.from_urdf(jax_load_urdf(ARM_URDF), jax_load_urdf(ARM_URDF).dof_names)
    jp_t = tfx.JointProperties.from_urdf(load_urdf(ARM_URDF), load_urdf(ARM_URDF).dof_names)
    rng = np.random.default_rng(5)
    t, Q, V, A = _multisine(rng, 400, 7, 100.0, amp=(0.3, 1.0))
    tau = 20.0 * rng.standard_normal((400, 13))  # 6 base-wrench columns, then the joints
    return SimpleNamespace(jp_j=jp_j, jp_t=jp_t, t=t, Q=Q, V=V, A=A, tau=tau)



def _jp_equal(a, b):
    for k, v in vars(a).items():
        w = getattr(b, k)
        if not (np.array_equal(v, w) if isinstance(v, np.ndarray) else v == w):
            return False
    return set(vars(a)) == set(vars(b))


@pytest.mark.parametrize("urdf", [ARM_URDF, H30_URDF], ids=["arm", "humanoid30"])
def test_joint_properties_match_jax(urdf):
    jt, tt = jax_load_urdf(urdf), load_urdf(urdf)
    jp_j = jfx.JointProperties.from_urdf(jt, jt.dof_names)
    jp_t = tfx.JointProperties.from_urdf(urdf, tt.dof_names)  # from a path, too
    assert _jp_equal(jp_t, jp_j)
    cfg = dict(simulateControlRate=500.0, simulateTorqueSensorError=0.02, simulateGravCompError=0.1,
               simulateStribeckVelocity=0.08, simulateCableStiffnessScale=2.0,
               simulateThermalWarmupTime=60.0)
    for _ in range(2):  # idempotent: the cable scale is not applied twice
        jp_j.apply_config(cfg)
        jp_t.apply_config(cfg)
    assert _jp_equal(jp_t, jp_j) and jp_t.control_rate == 500.0


SMOOTH = ["elasticity", "ripple", "friction", "friction_no_stribeck", "thermal", "cable",
          "gravity_residual", "deflection", "backlash"]


def _effect(fx, name, jp, A_, p):
    """One effect through a package: A_ turns a numpy array into the
    package's array."""
    off = 6
    if name == "elasticity":
        return fx.add_joint_elasticity(A_(p.tau), A_(p.A), 100.0, jp, off)
    if name == "ripple":
        return fx.add_torque_ripple(len(p.Q), A_(p.Q), jp, off)
    if name in ("friction", "friction_no_stribeck"):
        return fx.add_friction(A_(p.tau), A_(p.V), jp, off)
    if name == "thermal":
        return fx.add_temperature_friction_drift(A_(p.tau), A_(p.V), A_(p.t), jp, off)
    if name == "cable":
        return fx.add_cable_forces(A_(p.tau), A_(p.Q), jp, off, rng=np.random.default_rng(8))
    if name == "gravity_residual":
        return fx.add_gravity_compensation_residual(A_(p.tau), A_(p.Q), jp, off)
    if name == "deflection":
        return fx.add_structural_deflection(A_(p.Q), A_(p.tau), jp, off)
    if name == "backlash":
        return fx.add_backlash(A_(1e-3 * p.Q), A_(p.V), jp)
    if name == "torque_quantization":
        return fx.add_torque_quantization(A_(p.tau), jp, off)
    if name == "encoder_quantization":
        return fx.add_encoder_quantization(A_(p.Q), jp)
    raise KeyError(name)


@pytest.mark.parametrize("name", SMOOTH)
def test_smooth_effects_match_jax(arm_fx, name):
    p = arm_fx
    if name == "friction_no_stribeck":
        for jp in (p.jp_j, p.jp_t):
            jp.stribeck_velocity = 0.0
    try:
        want = np.asarray(_effect(jfx, name, p.jp_j, jnp.asarray, p))
        got = _effect(tfx, name, p.jp_t, T, p).numpy()
    finally:
        for jp in (p.jp_j, p.jp_t):
            jp.stribeck_velocity = 0.05
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)
    if name not in ("deflection", "backlash"):
        assert np.all(got[:, :6] == 0)  # nothing lands in the base-wrench columns
    if name == "backlash":  # the offsets stay inside the dead zone, and do something
        err = np.abs(got - 1e-3 * p.Q)
        assert np.all(err <= p.jp_t.backlash + 1e-15) and err.max() > 0


@pytest.mark.parametrize("name", ["torque_quantization", "encoder_quantization"])
def test_quantization_matches_jax(arm_fx, name):
    """Both round half to even; a value within rounding of a tie may land
    one quantum apart: at most 2 such entries, nothing larger."""
    p = arm_fx
    want = np.asarray(_effect(jfx, name, p.jp_j, jnp.asarray, p))
    got = _effect(tfx, name, p.jp_t, T, p).numpy()
    if name == "torque_quantization":
        q = 2.0 * p.jp_t.torque_limit / 2.0 ** p.jp_t.torque_quant_bits
        assert np.array_equal(got[:, :6], p.tau[:, :6])
        got, want = got[:, 6:], want[:, 6:]
    else:
        q = 2.0 * np.pi / 2.0 ** np.floor(p.jp_t.encoder_bits)
    steps = np.abs(got - want) / q
    assert steps.max() <= 1.0 + 1e-9 and int((steps > 0.5).sum()) <= 2
    assert np.abs(got / q - np.round(got / q)).max() < 1e-6  # on the grid


def test_effect_gradients_match_jax(arm_fx):
    """Straight-through rounding has the identity gradient; the backlash
    recursion's backward pass (the reversed recursion) and the grouped
    convolution of the elasticity agree with jax.grad."""
    p = arm_fx
    q = T(p.Q[:10]).requires_grad_(True)
    tfx.add_encoder_quantization(q, p.jp_t).sum().backward()
    assert torch.equal(q.grad, torch.ones_like(q))
    x = T(np.array([0.5, 1.5, 2.5, -0.5, 0.49999])).requires_grad_(True)
    y = tfx.st_round(x)
    assert y.tolist() == [0.0, 2.0, 2.0, -0.0, 0.0]  # half to even
    (y * T([1, 2, 3, 4, 5])).sum().backward()
    assert x.grad.tolist() == [1, 2, 3, 4, 5]

    w = np.random.default_rng(6).standard_normal((400, 7))
    Qb = 2e-4 * p.Q  # reversals inside and outside the dead zone
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jfx.add_backlash(a, None, p.jp_j)))(
        jnp.asarray(Qb))
    qb = T(Qb).requires_grad_(True)
    (T(w) * tfx.add_backlash(qb, None, p.jp_t)).sum().backward()
    assert np.abs(qb.grad.numpy() - np.asarray(want)).max() <= 1e-12
    frac_clamped = np.mean(np.abs(np.asarray(want) - w) > 1e-9)
    assert 0.05 < frac_clamped < 0.999  # both branches of the clamp are exercised

    wt = np.random.default_rng(7).standard_normal((400, 13))
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(wt) * jfx.add_joint_elasticity(
        jnp.asarray(p.tau), a, 100.0, p.jp_j, 6)))(jnp.asarray(p.A))
    a = T(p.A).requires_grad_(True)
    (T(wt) * tfx.add_joint_elasticity(T(p.tau), a, 100.0, p.jp_t, 6)).sum().backward()
    assert np.abs(a.grad.numpy() - np.asarray(want)).max() <= 1e-10 * np.abs(np.asarray(want)).max()


def test_host_side_effects_match_jax(arm_fx):
    """Timing jitter, sudden stops and the sensor-noise chain are numpy /
    scipy in both packages: equal arrays from equal seeds."""
    p = arm_fx
    assert np.array_equal(tfx.add_timing_jitter(p.t, 100.0, np.random.default_rng(1), jp=p.jp_t),
                          jfx.add_timing_jitter(p.t, 100.0, np.random.default_rng(1), jp=p.jp_j))
    for a, b in zip(tfx.add_sudden_stops(p.t, p.Q, p.V, p.A, 100.0, rng=np.random.default_rng(2)),
                    jfx.add_sudden_stops(p.t, p.Q, p.V, p.A, 100.0, rng=np.random.default_rng(2))):
        assert np.array_equal(a, b)
    base = np.random.default_rng(3).standard_normal((400, 15))
    kw = dict(base_rpy=base[:, :3], base_velocity=base[:, 3:9], base_acceleration=base[:, 9:])
    for jp_t, jp_j in ((p.jp_t, p.jp_j), (None, None)):
        got = tfx.add_sensor_noise(p.Q, p.V, p.tau, 100.0, np.random.default_rng(4), jp=jp_t, **kw)
        want = jfx.add_sensor_noise(p.Q, p.V, p.tau, 100.0, np.random.default_rng(4), jp=jp_j, **kw)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# modules 7-8: the simulator
# ----------------------------------------------------------------------
def _assert_measurements_match(got, want, device_keys):
    assert set(got) == set(want) == simulator.MEASUREMENT_KEYS
    for k in sorted(want):
        if k == "contacts":
            assert got[k].item(0) == want[k].item(0) == {}
            continue
        a, b = np.asarray(got[k], dtype=float), np.asarray(want[k], dtype=float)
        assert a.shape == b.shape, k
        if k in device_keys:
            assert np.abs(a - b).max() <= 1e-9 * max(np.abs(b).max(), 1.0), k
        else:
            assert np.array_equal(a, b), k


@pytest.mark.timeout(120)
def test_simulate_measurements_matches_jax(tmp_path):
    """The fixed-base arm, every effect on, 4 s at 100 Hz, seed 7."""
    assert simulator.MEASUREMENT_KEYS == jax_simulator.MEASUREMENT_KEYS
    t, Q, V, A = _multisine(np.random.default_rng(9), 400, 7, 100.0, amp=(0.3, 0.9))
    traj = dict(times=t, positions=Q, velocities=V, accelerations=A)
    path = tmp_path / "traj.npz"
    np.savez(path, **traj)
    loaded = simulator.load_trajectory_data(str(path))
    assert all(np.array_equal(loaded[k], traj[k]) for k in traj)
    tree = load_urdf(ARM_URDF)
    cfg = load_config(None, overrides=dict(
        floatingBase=0, excitationFrequency=100.0, computeDtype="float64", simulateRandomSeed=7,
        urdf=ARM_URDF, num_dofs=7, jointNames=list(tree.dof_names), verbose=0))
    want = jax_simulator.simulate_measurements(dict(cfg), traj, interactive=False)
    got = simulator.simulate_measurements(dict(cfg), loaded, interactive=False, device="cpu",
                                          existing=dict(note=np.array("kept")))
    assert str(got.pop("note")) == "kept"
    _assert_measurements_match(got, want, {
        "torques", "torques_raw", "positions", "positions_raw", "target_positions"})
    assert np.all(want["base_rpy"] == 0) and not np.array_equal(want["times"], t)  # jitter is on


@pytest.mark.timeout(180)
def test_generate_suspended_measurements_matches_jax(tmp_path):
    """humanoid30_real hanging from crane_ft, 4 s at 50 Hz, seed 0: the
    suspended-base integration, the RNEA torques and the effect chain,
    key by key; the npz on disk is what was returned."""
    ov = dict(computeDtype="float64")
    want = jcad.generate_suspended_measurements(H30_REAL, str(tmp_path / "j.npz"), duration=4.0,
                                                overrides=ov)
    got = cad_study.generate_suspended_measurements(H30_REAL, str(tmp_path / "t.npz"),
                                                    duration=4.0, overrides=ov, device="cpu")
    _assert_measurements_match(got, want, {
        "torques", "torques_raw", "positions", "positions_raw", "target_positions", "base_rpy",
        "base_velocity", "base_acceleration", "base_position"})
    assert got["torques"].shape == (200, 36) and np.abs(got["base_rpy"]).max() > 0.01
    with np.load(tmp_path / "t.npz", allow_pickle=True) as f:
        assert set(f.files) == simulator.MEASUREMENT_KEYS
        assert np.array_equal(f["torques"], got["torques"])
    exc_j = jcad._excitation(jax_load_urdf(H30_REAL), 2.0, 50.0, 3)
    exc_t = cad_study._excitation(load_urdf(H30_REAL), 2.0, 50.0, 3)
    assert all(np.array_equal(exc_t[k], exc_j[k]) for k in exc_j)
