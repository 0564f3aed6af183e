"""The port's static-posture optimizer against the JAX package, CPU.

Both packages read the 7-DOF arm's checked-in structural caches, so they
share one base projection (the floating-base case carries the JAX model's
projection over with `convert.py`). Tolerances: the port's objective in
f64 (`posture_objective`, the D-optimality of the gravity regressor and
the reference-parity ridge error) and its autograd gradient agree with the
same objective written on the JAX engine's regressor (`jax.grad`, f64) to
1e-8 relative (the parity error of exact torques is rounding-sized, so it
is held relative to ||xb_real||^2); the cross-entropy search alone (`useLocalOptimization=0`)
picks bitwise the same postures as the JAX package from one seed (the JAX
package ranks candidates in f32, the port in f64: the orders agree).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.excitation.posture import optimize_postures as jax_optimize_postures
from flobaroid_tpu.model import Model as JaxModel
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.excitation import posture
from flobaroid_tpu_torch.model import Model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
TOL = 1e-8
BASE = dict(useStructuralRegressor=1, computeDtype="float64", numStaticPostures=3,
            globalOptIterations=3, globalOptSize=8, verbose=0)
CASES = {
    # the checked-in caches: 600 states (inertial), 400 (gravity only)
    "dopt": dict(floatingBase=0, randomSamples=600),
    "dopt_floating": dict(floatingBase=1, randomSamples=300),
    "parity": dict(floatingBase=0, randomSamples=400, identifyGravityParamsOnly=1,
                   identifyFrictionSimultaneously=0),
}


def _pair(tmp_path, case):
    """(opt, JAX model, port model on the CPU) with one projection."""
    for suffix in ("", ".regressor.npz", ".gravity_regressor.npz"):
        shutil.copy(ARM_URDF + suffix, str(tmp_path / "arm.urdf") + suffix)
    urdf = str(tmp_path / "arm.urdf")
    opt = load_config(None, overrides={**BASE, **CASES[case]})
    jm = JaxModel(dict(opt), urdf)
    if case == "dopt_floating":
        tm = Model(dict(opt), urdf, regressor_init=False, device="cpu")
        tm.load_state(state_from_jax_model(jm))
    else:
        tm = Model(dict(opt), urdf, device="cpu")
    np.testing.assert_array_equal(tm.Pb, jm.Pb)
    return opt, jm, tm


def _jax_objective(jm, opt, x_std_real=None):
    """The posture objective on the JAX engine's regressor: values and
    gradients of K posture sets."""
    eng, nd = jm.engine, jm.num_dofs
    n_post = int(opt["numStaticPostures"])
    keep = jnp.asarray([p for p in range(jm.num_model_params) if p % 10 < 4])
    Pb = jnp.asarray(jm.Pb)

    def obj(flat):
        Qs = flat.reshape(n_post, nd)
        Z = jnp.zeros_like(Qs)
        if opt["floatingBase"]:
            Y = eng.regressor_batch(Qs, Z, Z, jnp.broadcast_to(jnp.eye(3), (n_post, 3, 3)),
                                    jnp.zeros((n_post, 6)), jnp.zeros((n_post, 6)))
        else:
            Y = eng.regressor_batch(Qs, Z, Z)
        Yf = Y[:, :, keep].reshape(-1, keep.shape[0])
        if x_std_real is not None:
            pi = jnp.asarray(x_std_real)[keep]
            YB, tau = Yf @ Pb, Yf @ pi
            GB = YB.T @ YB
            ridge = 1e-8 * jnp.trace(GB) / GB.shape[0]
            xb = jnp.linalg.solve(GB + ridge * jnp.eye(GB.shape[0]), YB.T @ tau)
            return jnp.sum((xb - jnp.asarray(jm.K) @ pi) ** 2)
        ev = jnp.linalg.eigvalsh(Yf.T @ Yf)
        return -jnp.sum(jnp.log(ev + 1e-4 * jnp.maximum(ev[-1], 1e-30)))

    return jax.jit(jax.vmap(jax.value_and_grad(obj)))


@pytest.mark.parametrize("case", list(CASES))
def test_objective_and_gradient_match_jax(tmp_path, case):
    opt, jm, tm = _pair(tmp_path, case)
    x_real = np.asarray(tm.tree.std_params()) * 1.1 if case == "parity" else None
    lo, hi = posture.posture_bounds(tm)
    n_post = int(opt["numStaticPostures"])
    X = np.random.default_rng(0).uniform(np.tile(lo, n_post), np.tile(hi, n_post),
                                         (6, n_post * tm.num_dofs))
    want_v, want_g = (np.asarray(a) for a in _jax_objective(jm, opt, x_real)(jnp.asarray(X)))
    Xt = torch.as_tensor(X).requires_grad_(True)
    v = posture.posture_objective(tm, opt, x_real, dtype=torch.float64)(Xt)
    (g,) = torch.autograd.grad(v.sum(), Xt)
    # the parity objective of exact torques is rounding-sized: it is held
    # relative to ||xb_real||^2, the value of a set that determines nothing
    scale = np.abs(want_v).max()
    if case == "parity":
        keep = [p for p in range(tm.num_model_params) if p % 10 < 4]
        scale = float(np.sum((tm.K @ x_real[keep]) ** 2))
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=TOL, atol=TOL * scale)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=TOL, atol=TOL * max(np.abs(want_g).max(),
                                                                           scale))


@pytest.mark.parametrize("case", ["dopt", "dopt_floating"])
def test_cem_only_postures_equal_jax(tmp_path, case):
    opt, jm, tm = _pair(tmp_path, case)
    cfg = dict(opt, useLocalOptimization=0)
    want = jax_optimize_postures(jm, dict(cfg))
    got = posture.optimize_postures(tm, dict(cfg), dtype=torch.float64)
    assert len(got) == 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_parity_objective_refines_and_refuses_a_full_model(tmp_path):
    """With ground-truth parameters the postures identify the gravity base
    parameters from exact torques no worse than a fixed posture set, the
    Adam refinement does not lose to the search alone, and a model that
    identifies more than the gravity columns raises (as in
    tests/test_trajectory.py)."""
    opt, jm, tm = _pair(tmp_path, "parity")
    x_real = np.asarray(tm.tree.std_params())
    objective = posture.posture_objective(tm, opt, x_real, dtype=torch.float64)
    lo, hi = posture.posture_bounds(tm)
    cem = posture.optimize_postures(tm, dict(opt, useLocalOptimization=0), x_std_real=x_real,
                                    dtype=torch.float64)
    angles = posture.optimize_postures(tm, dict(opt), x_std_real=x_real, dtype=torch.float64)
    for a in angles:
        assert np.all(a >= lo - 1e-9) and np.all(a <= hi + 1e-9)

    def value(postures):
        return float(objective(torch.as_tensor(np.concatenate(postures))[None])[0])

    fixed = [np.full(tm.num_dofs, 0.1 * i) for i in range(3)]
    assert value(angles) <= value(cem) <= value(fixed) + 1e-12
    full = Model(dict(opt, identifyGravityParamsOnly=0, randomSamples=600),
                 str(tmp_path / "arm.urdf"), device="cpu")
    with pytest.raises(ValueError, match="identifyGravityParamsOnly"):
        posture.optimize_postures(full, dict(opt, identifyGravityParamsOnly=0), x_std_real=x_real)


def test_default_dtype_is_float32(tmp_path):
    """The objective runs in f32 by default, as the JAX package's does,
    and the search in f32 finds a posture set within the bounds."""
    opt, _, tm = _pair(tmp_path, "dopt")
    X = np.zeros((2, 3 * tm.num_dofs))
    assert posture.posture_objective(tm, opt)(torch.as_tensor(X, dtype=torch.float32)).dtype \
        == torch.float32
    got = posture.optimize_postures(tm, dict(opt, globalOptIterations=1))
    lo, hi = posture.posture_bounds(tm)
    assert all(np.all(a >= lo - 1e-9) and np.all(a <= hi + 1e-9) for a in got)
