"""The port's Euler-Lagrange oracle against the JAX package, CPU, f64.

The `rr` robot of `tests/test_dynamics.py` (revolute, revolute with a
tilted axis, prismatic, fixed tool) at states made with numpy seeds goes
through `flobaroid_tpu.dynamics.lagrangian` and
`flobaroid_tpu_torch.dynamics.lagrangian`. Tolerances: fixed- and
floating-base torques, energies, `omega_world` and `euler_map` agree with
JAX's to 1e-10 (relative to the largest magnitude; measured ~1e-16); the
port's RNEA (`inverse_dynamics_batch`) agrees with the oracle within
`tests/test_dynamics.py`'s tolerances (rtol 1e-8 fixed, 1e-7 floating).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu.dynamics import lagrangian as jlag
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu_torch.dynamics import lagrangian as lag
from flobaroid_tpu_torch.dynamics import spatial as sp
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
from flobaroid_tpu_torch.models.urdf import load_urdf

from test_dynamics import SIMPLE_URDF

torch.set_num_threads(2)

TOL = 1e-10


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def rr():
    jt, tt = jax_load_urdf(SIMPLE_URDF), load_urdf(SIMPLE_URDF)
    return JaxEngine(jt), DynamicsEngine(tt), np.asarray(tt.std_params())


@pytest.fixture(scope="module")
def jax_oracle(rr):
    """JAX's inverse dynamics and energies, compiled once per module."""
    je = rr[0]
    return (jax.jit(lambda *a: jlag.inverse_dynamics_fixed(je, *a)),
            jax.jit(lambda *a: jlag.inverse_dynamics_floating(je, *a)),
            jax.jit(lambda *a: jlag.energies(je, *a)))


def _state(seed, n):
    """(q, dq, ddq, rpy, drpy, ddrpy, dpb, ddpb) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, n), rng.normal(size=n), rng.normal(size=n),
            0.4 * rng.normal(size=3), rng.normal(size=3), rng.normal(size=3),
            rng.normal(size=3), rng.normal(size=3))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), (got, want)


def _mixed_base(rpy, drpy, ddrpy, dpb, ddpb):
    """world_R_base and the mixed base velocity/acceleration of an rpy
    trajectory, through the port's omega_world."""
    w, wd = torch.func.jvp(lambda r, rd: lag.omega_world(r, rd), (T(rpy), T(drpy)),
                           (T(drpy), T(ddrpy)))
    return (sp.rpy_to_rot(T(rpy)).T, torch.cat([T(dpb), w]), torch.cat([T(ddpb), wd]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fixed_base_matches_jax_and_rnea(rr, jax_oracle, seed):
    je, te, pi = rr
    q, dq, ddq, *_ = _state(seed, te.num_dofs)
    got = lag.inverse_dynamics_fixed(te, T(pi), T(q), T(dq), T(ddq)).numpy()
    want = jax_oracle[0](jnp.asarray(pi), *(jnp.asarray(a) for a in (q, dq, ddq)))
    _close(got, want)
    rnea = te.inverse_dynamics_batch(T(pi), T(q)[None], T(dq)[None], T(ddq)[None])[0].numpy()
    np.testing.assert_allclose(rnea, got, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_floating_base_matches_jax_and_rnea(rr, jax_oracle, seed):
    je, te, pi = rr
    state = _state(seed, te.num_dofs)
    got = lag.inverse_dynamics_floating(te, T(pi), *(T(a) for a in state)).numpy()
    want = jax_oracle[1](jnp.asarray(pi), *(jnp.asarray(a) for a in state))
    _close(got, want)
    q, dq, ddq = state[:3]
    br, bv, ba = _mixed_base(*state[3:])
    rnea = te.inverse_dynamics_batch(T(pi), T(q)[None], T(dq)[None], T(ddq)[None],
                                     br[None], bv[None], ba[None])[0].numpy()
    np.testing.assert_allclose(rnea, got, rtol=1e-7, atol=1e-8)


def test_energies_and_euler_map_match_jax(rr, jax_oracle):
    je, te, pi = rr
    rng = np.random.default_rng(5)
    n = te.num_dofs
    for _ in range(3):
        x, xd = rng.normal(size=6 + n), rng.normal(size=6 + n)
        got = lag.energies(te, T(pi), T(x), T(xd))
        want = jax_oracle[2](jnp.asarray(pi), jnp.asarray(x), jnp.asarray(xd))
        _close([float(v) for v in got], [float(v) for v in want])
        rpy, drpy = rng.normal(size=3), rng.normal(size=3)
        E = lag.euler_map(T(rpy))
        _close(E.numpy(), jlag.euler_map(jnp.asarray(rpy)))
        _close(lag.omega_world(T(rpy), T(drpy)).numpy(),
               jlag.omega_world(jnp.asarray(rpy), jnp.asarray(drpy)))
        _close((E @ T(drpy)).numpy(), lag.omega_world(T(rpy), T(drpy)).numpy())
    # at rest under gravity the kinetic energy is zero and the potential
    # energy is -sum m g.c over the links
    x = np.concatenate([np.zeros(6), rng.normal(size=n)])
    kin, pot = lag.energies(te, T(pi), T(x), torch.zeros(6 + n, dtype=torch.float64))
    assert float(kin) == 0.0
    R, p = te.fk(T(x[6:]))
    p10 = T(pi).reshape(-1, 10)
    com_w = (R @ p10[:, 1:4, None])[..., 0] + p10[:, :1] * p
    assert abs(float(pot) - 9.81 * float(com_w[:, 2].sum())) < 1e-12


def test_jvp_of_fk_matches_jax(rr):
    """The velocities the oracle rests on: forward-mode derivatives of
    the world FK, through the engine's `fk`, equal JAX's."""
    je, te, _ = rr
    rng = np.random.default_rng(9)
    x, xd = rng.normal(size=6 + te.num_dofs), rng.normal(size=6 + te.num_dofs)
    (R, p), (Rd, pd) = torch.func.jvp(lambda a: lag._world_fk(te, a), (T(x),), (T(xd),))
    (jR, jp), (jRd, jpd) = jax.jvp(lambda a: jlag._world_fk(je, a), (jnp.asarray(x),),
                                   (jnp.asarray(xd),))
    for a, b in ((R, jR), (p, jp), (Rd, jRd), (pd, jpd)):
        _close(a.numpy(), b)
