"""Parity of the PyTorch port's dynamics engine with the JAX engine.

Same inputs (numpy seed) through flobaroid_tpu.dynamics.engine and
flobaroid_tpu_torch.dynamics.engine on the 7-DOF arm, the small
revolute/prismatic chain of test_dynamics.py and a mimic model, fixed
and floating base, N = 32. Each engine gets its tree from its own
package's `load_urdf`. Tolerances: f64 1e-10 relative to max|Y|
(both sides compute the same formulas in f64; differences are rounding
order), f32 1e-5 (the port in f32 against the JAX engine in f64: f32
rounding of the kinematic chain). Frame Jacobians (the walking
contacts' J^T w) also on humanoid30, at 1e-12 in f64. The derived
quantities (mass matrix, bias forces, frame velocity, total mass, centre
of mass, F/T sensor wrench regressor) on the arm (fixed base) and
humanoid30 (floating base): 1e-10 in f64; in f32 1e-4 of the largest
entry on humanoid30, whose chain is deeper and whose base velocity
enters the bias forces squared, 1e-5 on the arm.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.dynamics import spatial as jsp
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.dynamics.engine import rpy_to_base_rot as jax_rpy_to_base_rot
from flobaroid_tpu.models import geometry as jgeo
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu_torch.dynamics import spatial as tsp
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine, rpy_to_base_rot, rpy_to_base_rot_np
from flobaroid_tpu_torch.models import geometry as tgeo
from flobaroid_tpu_torch.models.urdf import load_urdf

from test_dynamics import SIMPLE_URDF
from test_mimic import MIMIC_URDF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
N = 32
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def robots(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dyn")
    out = {"arm": ARM_URDF, "humanoid30": H30_URDF}
    for name, text in (("simple", SIMPLE_URDF), ("mimic", MIMIC_URDF)):
        p = d / f"{name}.urdf"
        p.write_text(text)
        out[name] = str(p)
    return {k: (jax_load_urdf(v), load_urdf(v)) for k, v in out.items()}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "examples", "models", "*.urdf"))),
                         ids=os.path.basename)
def test_load_urdf_matches_jax(path):
    """The port's copy of the URDF parser and bounding boxes gives the JAX
    package's names, DOF order, limits and a-priori parameters."""
    j, t = jax_load_urdf(path), load_urdf(path)
    assert t.dof_names == j.dof_names and t.link_names == j.link_names
    assert [x.name for x in t.joints] == [x.name for x in j.joints]
    assert np.array_equal(t.std_params(), j.std_params())
    assert np.array_equal(t.parent_link, j.parent_link) and t.mimic_map == j.mimic_map
    assert t.joint_limits() == j.joint_limits()
    for name in j.link_names:
        assert np.array_equal(np.asarray(tgeo.link_bounding_box(t, name, scale=1.1)),
                              np.asarray(jgeo.link_bounding_box(j, name, scale=1.1)))


_JAX = {}


def _jax_reference(tree, robot, fn, floating, seed):
    """JAX engine output on the seeded inputs, computed once per case: the
    f64 and f32 port runs are both held against it."""
    key = (robot, fn, floating, seed)
    if key not in _JAX:
        if (robot, "engine") not in _JAX:
            _JAX[(robot, "engine")] = JaxEngine(tree)
        eng = _JAX[(robot, "engine")]
        args = _jax_args(_inputs(tree, seed), floating)
        if fn == "regressor_batch":
            _JAX[key] = np.asarray(eng.regressor_batch(*args))
        else:
            _JAX[key] = np.asarray(eng.inverse_dynamics_batch(jnp.asarray(tree.std_params()), *args))
    return _JAX[key]


def _inputs(tree, seed=0):
    rng = np.random.default_rng(seed)
    n = tree.num_dofs
    Q = rng.uniform(-1, 1, (N, n))
    V = rng.standard_normal((N, n))
    A = rng.standard_normal((N, n))
    rpy = rng.random((N, 3)) * 0.3
    BV = rng.standard_normal((N, 6))
    BA = rng.standard_normal((N, 6))
    return Q, V, A, rpy_to_base_rot_np(rpy), BV, BA


def _jax_args(arrs, floating):
    a = [jnp.asarray(x) for x in arrs]
    return a if floating else a[:3]


def _torch_args(arrs, floating, dtype):
    a = [torch.tensor(x, dtype=dtype) for x in arrs]
    return a if floating else a[:3]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


CASES = [(r, fl, dt) for r in ("arm", "simple", "mimic") for fl in (False, True)
         for dt in (torch.float64, torch.float32)]
IDS = [f"{r}-{'floating' if fl else 'fixed'}-{str(dt)[6:]}" for r, fl, dt in CASES]


@pytest.mark.parametrize("robot,floating,dtype", CASES, ids=IDS)
def test_regressor_batch_matches_jax(robots, robot, floating, dtype):
    jtree, tree = robots[robot]
    arrs = _inputs(tree)
    Yj = _jax_reference(jtree, robot, "regressor_batch", floating, seed=0)
    Yt = DynamicsEngine(tree).regressor_batch(*_torch_args(arrs, floating, dtype))
    assert Yt.dtype == dtype and tuple(Yt.shape) == Yj.shape
    assert _rel(Yt.double().numpy(), Yj) < TOL[dtype]


@pytest.mark.parametrize("robot,floating,dtype", CASES, ids=IDS)
def test_inverse_dynamics_batch_matches_jax(robots, robot, floating, dtype):
    jtree, tree = robots[robot]
    arrs = _inputs(tree, seed=1)
    pi = tree.std_params()
    tj = _jax_reference(jtree, robot, "inverse_dynamics_batch", floating, seed=1)
    tt = DynamicsEngine(tree).inverse_dynamics_batch(
        torch.tensor(pi, dtype=dtype), *_torch_args(arrs, floating, dtype))
    assert tuple(tt.shape) == tj.shape
    assert _rel(tt.double().numpy(), tj) < TOL[dtype]


@pytest.mark.parametrize("robot", ["arm", "simple", "mimic"])
@pytest.mark.parametrize("floating", [False, True], ids=["fixed", "floating"])
def test_regressor_rnea_identity(robots, robot, floating):
    """The port's own Y(q, dq, ddq) @ pi == RNEA(q, dq, ddq; pi)."""
    _, tree = robots[robot]
    eng = DynamicsEngine(tree)
    args = _torch_args(_inputs(tree, seed=2), floating, torch.float64)
    pi = torch.tensor(tree.std_params())
    Y = eng.regressor_batch(*args)
    tau = eng.inverse_dynamics_batch(pi, *args)
    assert _rel((Y @ pi).numpy(), tau.numpy()) < 1e-10


def test_single_sample_and_fk_match_jax(robots):
    jtree, tree = robots["arm"]
    Q, V, A, BR, BV, BA = _inputs(tree, seed=3)
    je, te = JaxEngine(jtree), DynamicsEngine(tree)
    Rj, pj = je.fk(jnp.asarray(Q[0]))
    Rt, pt = te.fk(torch.tensor(Q[0]))
    assert _rel(Rt.numpy(), Rj) < 1e-12 and _rel(pt.numpy(), pj) < 1e-12
    yj = je.regressor(*(jnp.asarray(x[0]) for x in (Q, V, A, BR, BV, BA)))
    yt = te.regressor(*(torch.tensor(x[0]) for x in (Q, V, A, BR, BV, BA)))
    assert _rel(yt.numpy(), yj) < 1e-10
    pi = tree.std_params()
    tj = je.inverse_dynamics(jnp.asarray(pi), *(jnp.asarray(x[0]) for x in (Q, V, A)))
    tt = te.inverse_dynamics(torch.tensor(pi), *(torch.tensor(x[0]) for x in (Q, V, A)))
    assert _rel(tt.numpy(), tj) < 1e-10


def test_rotation_conventions_match_jax():
    """rpy <-> rotation in numpy and torch against the JAX definitions
    (data.py's IMU processing uses the numpy forms)."""
    rng = np.random.default_rng(4)
    rpy = (rng.random((16, 3)) - 0.5) * np.array([2.0, 1.5, 2.0])
    Rj = np.asarray(jsp.rpy_to_rot(jnp.asarray(rpy)))
    assert np.abs(tsp.rpy_to_rot_np(rpy) - Rj).max() < 1e-14
    assert np.abs(tsp.rpy_to_rot(torch.tensor(rpy)).numpy() - Rj).max() < 1e-14
    back_j = np.asarray(jsp.rot_to_rpy(jnp.asarray(Rj)))
    assert np.abs(tsp.rot_to_rpy_np(Rj) - back_j).max() < 1e-12
    assert np.abs(tsp.rot_to_rpy(torch.tensor(Rj)).numpy() - back_j).max() < 1e-12
    assert np.abs(back_j - rpy).max() < 1e-12
    assert np.abs(rpy_to_base_rot(torch.tensor(rpy)).numpy()
                  - np.asarray(jax_rpy_to_base_rot(jnp.asarray(rpy)))).max() < 1e-14


def test_spatial_primitives_match_jax():
    rng = np.random.default_rng(5)
    v, m = rng.standard_normal((2, 8, 6))
    p10 = rng.standard_normal((8, 10))
    ax = rng.standard_normal((8, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.standard_normal(8)
    pairs = [
        (tsp.crm(torch.tensor(v), torch.tensor(m)), jsp.crm(jnp.asarray(v), jnp.asarray(m))),
        (tsp.crf(torch.tensor(v), torch.tensor(m)), jsp.crf(jnp.asarray(v), jnp.asarray(m))),
        (tsp.L_of(torch.tensor(v[:, :3])), jsp.L_of(jnp.asarray(v[:, :3]))),
        (tsp.inertia_matrix_from_params(torch.tensor(p10)),
         jsp.inertia_matrix_from_params(jnp.asarray(p10))),
        (tsp.axis_angle_rot(torch.tensor(ax), torch.tensor(ang)),
         jsp.axis_angle_rot(jnp.asarray(ax), jnp.asarray(ang))),
        (tsp.unskew(tsp.skew(torch.tensor(v[:, :3]))), jsp.unskew(jsp.skew(jnp.asarray(v[:, :3])))),
    ]
    for t, j in pairs:
        assert np.abs(t.numpy() - np.asarray(j)).max() < 1e-13


@pytest.mark.timeout(120)
@pytest.mark.parametrize("robot", ["arm", "humanoid30", "mimic"])
@pytest.mark.parametrize("floating", [False, True], ids=["fixed", "floating"])
def test_frame_jacobian_matches_jax(robots, robot, floating):
    """Mixed 6 x (6+n) frame Jacobians, batched over samples, against the
    JAX engine's single-sample one vmapped: the last link and a middle
    one, and on humanoid30 the foot F/T frames the walking contacts use."""
    import jax

    jtree, tree = robots[robot]
    Q, _, _, BR, _, _ = _inputs(tree, seed=6)
    je, te = JaxEngine(jtree), DynamicsEngine(tree)
    if robot == "humanoid30":
        links = {tree.link_index["L_foot_ft"], tree.link_index["R_foot_ft"]}
    else:
        links = {tree.num_links - 1, tree.num_links // 2}
    for li in sorted(links):
        if floating:
            Jj = jax.vmap(lambda q, br: je.frame_jacobian(li, q, br))(jnp.asarray(Q), jnp.asarray(BR))
            Jt = te.frame_jacobian(li, torch.tensor(Q), torch.tensor(BR))
        else:
            Jj = jax.vmap(lambda q: je.frame_jacobian(li, q))(jnp.asarray(Q))
            Jt = te.frame_jacobian(li, torch.tensor(Q))
        assert tuple(Jt.shape) == (N, 6, 6 + tree.num_dofs)
        assert _rel(Jt.numpy(), np.asarray(Jj)) < 1e-12, li


DERIVED = ["mass_matrix", "bias_forces", "frame_velocity", "total_mass", "com_world",
           "sensor_wrench_regressor"]
DERIVED_TOL = {("arm", torch.float64): 1e-10, ("humanoid30", torch.float64): 1e-10,
               ("arm", torch.float32): 1e-5, ("humanoid30", torch.float32): 1e-4}
_DERIVED_JAX = {}


def _derived_jax(robots, robot, fn):
    """The JAX engine's single-sample function vmapped over the seeded
    samples, once per (robot, function): the arm with a fixed base,
    humanoid30 floating."""
    import jax

    if (robot, fn) in _DERIVED_JAX:
        return _DERIVED_JAX[(robot, fn)]
    jtree, tree = robots[robot]
    je = JaxEngine(jtree)
    fl = robot == "humanoid30"
    Q, V, A, BR, BV, BA = (jnp.asarray(a) for a in _inputs(tree, seed=7))
    pi = jnp.asarray(tree.std_params())
    li = tree.num_links - 1
    sl = (0, tree.num_links // 2, li)
    if fn == "mass_matrix":
        out = (jax.vmap(lambda q, br: je.mass_matrix(pi, q, br, floating=True))(Q, BR) if fl
               else jax.vmap(lambda q: je.mass_matrix(pi, q))(Q))
    elif fn == "bias_forces":
        out = (jax.vmap(lambda q, dq, br, bv: je.bias_forces(pi, q, dq, br, bv, floating=True))(
            Q, V, BR, BV) if fl else jax.vmap(lambda q, dq: je.bias_forces(pi, q, dq))(Q, V))
    elif fn == "frame_velocity":
        if not fl:
            BR, BV = jnp.broadcast_to(jnp.eye(3), (N, 3, 3)), jnp.zeros((N, 6))
        out = jax.vmap(lambda q, dq, br, bv: je.frame_velocity(li, q, dq, br, bv))(Q, V, BR, BV)
    elif fn == "total_mass":
        out = je.total_mass(pi)
    elif fn == "com_world":
        out = (jax.vmap(lambda q, br: je.com_world(pi, q, br))(Q, BR) if fl
               else jax.vmap(lambda q: je.com_world(pi, q))(Q))
    else:
        out = (jax.vmap(lambda *a: je.sensor_wrench_regressor(sl, *a))(Q, V, A, BR, BV, BA) if fl
               else jax.vmap(lambda *a: je.sensor_wrench_regressor(sl, *a))(Q, V, A))
    _DERIVED_JAX[(robot, fn)] = np.asarray(out)
    return _DERIVED_JAX[(robot, fn)]


def _derived_torch(tree, robot, fn, dtype):
    te = DynamicsEngine(tree)
    fl = robot == "humanoid30"
    Q, V, A, BR, BV, BA = (torch.tensor(a, dtype=dtype) for a in _inputs(tree, seed=7))
    pi = torch.tensor(tree.std_params(), dtype=dtype)
    li = tree.num_links - 1
    sl = (0, tree.num_links // 2, li)
    if fn == "mass_matrix":
        return te.mass_matrix(pi, Q, BR, floating=True) if fl else te.mass_matrix(pi, Q)
    if fn == "bias_forces":
        return (te.bias_forces(pi, Q, V, BR, BV, floating=True) if fl
                else te.bias_forces(pi, Q, V))
    if fn == "frame_velocity":
        if not fl:
            BR, BV = torch.eye(3, dtype=dtype).expand(N, 3, 3), torch.zeros((N, 6), dtype=dtype)
        return te.frame_velocity(li, Q, V, BR, BV)
    if fn == "total_mass":
        return te.total_mass(pi)
    if fn == "com_world":
        return te.com_world(pi, Q, BR) if fl else te.com_world(pi, Q)
    return (te.sensor_wrench_regressor(sl, Q, V, A, BR, BV, BA) if fl
            else te.sensor_wrench_regressor(sl, Q, V, A))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("robot", ["arm", "humanoid30"])
@pytest.mark.parametrize("fn", DERIVED)
def test_derived_quantities_match_jax(robots, fn, robot, dtype):
    ref = _derived_jax(robots, robot, fn)
    out = _derived_torch(robots[robot][1], robot, fn, dtype)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    assert _rel(out.double().numpy(), ref) < DERIVED_TOL[(robot, dtype)]


@pytest.mark.parametrize("robot", ["arm", "humanoid30", "mimic"])
def test_mass_matrix_symmetric_and_consistent_with_inverse_dynamics(robots, robot):
    """M(q) is symmetric positive semidefinite (a link without inertia
    about its joint axis leaves a zero eigenvalue), and with zero base velocity
    M(q) [base_acc; ddq] + bias(q, dq) equals the inverse dynamics
    (floating base; the arm also with a fixed base)."""
    _, tree = robots[robot]
    te = DynamicsEngine(tree)
    Q, V, A, BR, _, BA = (torch.tensor(a) for a in _inputs(tree, seed=8))
    BV = torch.zeros_like(BA)
    pi = torch.tensor(tree.std_params())
    M = te.mass_matrix(pi, Q, BR, floating=True)
    assert tuple(M.shape) == (N, 6 + tree.num_dofs, 6 + tree.num_dofs)
    assert float((M - M.transpose(1, 2)).abs().max()) < 1e-12 * float(M.abs().max())
    assert float(torch.linalg.eigvalsh(M).min()) > -1e-12 * float(M.abs().max())
    tau = te.inverse_dynamics_batch(pi, Q, V, A, BR, BV, BA)
    acc = torch.cat([BA, A], dim=1)
    rebuilt = (M @ acc[..., None])[..., 0] + te.bias_forces(pi, Q, V, BR, BV, floating=True)
    assert _rel(rebuilt.numpy(), tau.numpy()) < 1e-10
    if robot == "arm":
        Mf = te.mass_matrix(pi, Q)
        assert _rel(Mf.numpy(), M[:, 6:, 6:].numpy()) < 1e-12
        rebuilt = (Mf @ A[..., None])[..., 0] + te.bias_forces(pi, Q, V)
        assert _rel(rebuilt.numpy(), te.inverse_dynamics_batch(pi, Q, V, A).numpy()) < 1e-10
