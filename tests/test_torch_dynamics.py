"""Parity of the PyTorch port's dynamics engine with the JAX engine.

Same inputs (numpy seed) through flobaroid_tpu.dynamics.engine and
flobaroid_tpu_torch.dynamics.engine on the 7-DOF arm, the small
revolute/prismatic chain of test_dynamics.py and a mimic model, fixed
and floating base, N = 32. Tolerances: f64 1e-10 relative to max|Y|
(both sides compute the same formulas in f64; differences are rounding
order), f32 1e-5 (the port in f32 against the JAX engine in f64: f32
rounding of the kinematic chain).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.dynamics import spatial as jsp
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.dynamics.engine import rpy_to_base_rot as jax_rpy_to_base_rot
from flobaroid_tpu.models.urdf import load_urdf
from flobaroid_tpu_torch.dynamics import spatial as tsp
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine, rpy_to_base_rot, rpy_to_base_rot_np

from test_dynamics import SIMPLE_URDF
from test_mimic import MIMIC_URDF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
N = 32
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def robots(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dyn")
    out = {"arm": ARM_URDF}
    for name, text in (("simple", SIMPLE_URDF), ("mimic", MIMIC_URDF)):
        p = d / f"{name}.urdf"
        p.write_text(text)
        out[name] = str(p)
    return {k: load_urdf(v) for k, v in out.items()}


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
    tree = robots[robot]
    arrs = _inputs(tree)
    Yj = _jax_reference(tree, robot, "regressor_batch", floating, seed=0)
    Yt = DynamicsEngine(tree).regressor_batch(*_torch_args(arrs, floating, dtype))
    assert Yt.dtype == dtype and tuple(Yt.shape) == Yj.shape
    assert _rel(Yt.double().numpy(), Yj) < TOL[dtype]


@pytest.mark.parametrize("robot,floating,dtype", CASES, ids=IDS)
def test_inverse_dynamics_batch_matches_jax(robots, robot, floating, dtype):
    tree = robots[robot]
    arrs = _inputs(tree, seed=1)
    pi = tree.std_params()
    tj = _jax_reference(tree, robot, "inverse_dynamics_batch", floating, seed=1)
    tt = DynamicsEngine(tree).inverse_dynamics_batch(
        torch.tensor(pi, dtype=dtype), *_torch_args(arrs, floating, dtype))
    assert tuple(tt.shape) == tj.shape
    assert _rel(tt.double().numpy(), tj) < TOL[dtype]


@pytest.mark.parametrize("robot", ["arm", "simple", "mimic"])
@pytest.mark.parametrize("floating", [False, True], ids=["fixed", "floating"])
def test_regressor_rnea_identity(robots, robot, floating):
    """The port's own Y(q, dq, ddq) @ pi == RNEA(q, dq, ddq; pi)."""
    tree = robots[robot]
    eng = DynamicsEngine(tree)
    args = _torch_args(_inputs(tree, seed=2), floating, torch.float64)
    pi = torch.tensor(tree.std_params())
    Y = eng.regressor_batch(*args)
    tau = eng.inverse_dynamics_batch(pi, *args)
    assert _rel((Y @ pi).numpy(), tau.numpy()) < 1e-10


def test_single_sample_and_fk_match_jax(robots):
    tree = robots["arm"]
    Q, V, A, BR, BV, BA = _inputs(tree, seed=3)
    je, te = JaxEngine(tree), DynamicsEngine(tree)
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
