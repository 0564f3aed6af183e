"""Energy-based (Euler-Lagrange) inverse dynamics oracle.

Counterpart of flobaroid_tpu/dynamics/lagrangian.py: an independent
formulation of the robot dynamics used to validate the recursive engine.
Link velocities come from forward-mode differentiation of forward
kinematics (`torch.func.jvp`, not the engine's velocity propagation) and
torques from differentiating the Lagrangian (not from Newton-Euler wrench
sums). Functions take one state (no sample axis) and follow its dtype
and device; the second derivatives are torch.func's forward-over-reverse
(`jvp` of `grad`) through the engine's own `fk`.

The engine caches its structure constants per (dtype, device) on first
use. A constant first made inside a torch.func transform is tied to that
transform and fails ("escaped?") once it is reused outside it, so every
entry point builds the cache before it enters a transform.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, jvp

from . import spatial as sp
from .engine import DynamicsEngine


def _body_twists_from_fk(Rw, pw, Rd, pd):
    """Body-frame [w; v] from FK values and their time derivatives."""
    RwT = Rw.transpose(-1, -2)
    Wl = RwT @ Rd
    Wl = 0.5 * (Wl - Wl.transpose(-1, -2))
    w = sp.unskew(Wl)
    v = (RwT @ pd[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def _world_fk(engine: DynamicsEngine, x):
    """World FK from generalized coords x = [p_base(3), rpy(3), q(n)].

    Uses the npz storage convention world_R_base = RPY(rpy)^T
    (see engine.rpy_to_base_rot)."""
    pb, rpy, q = x[:3], x[3:6], x[6:]
    Rwb = sp.rpy_to_rot(rpy).T
    R, p = engine.fk(q)
    Rw = Rwb @ R
    pw = pb + (Rwb @ p[..., None])[..., 0]
    return Rw, pw


def energies(engine: DynamicsEngine, pi, x, xd):
    """Kinetic and potential energy at generalized state (x, xd)."""
    engine._c(x.dtype, x.device)
    (Rw, pw), (Rd, pd) = jvp(lambda xx: _world_fk(engine, xx), (x,), (xd,))
    nu = _body_twists_from_fk(Rw, pw, Rd, pd)
    p10 = pi.reshape(engine.num_links, 10)
    I6 = sp.inertia_matrix_from_params(p10)
    T = 0.5 * torch.einsum("li,lij,lj->", nu, I6, nu)
    g = torch.as_tensor(engine.gravity, dtype=x.dtype, device=x.device)
    # V = -sum_i m_i g . c_i^world ; m*c^world = R h + m p
    h_w = (Rw @ p10[:, 1:4, None])[..., 0] + p10[:, 0:1] * pw
    V = -torch.sum(h_w @ g)
    return T, V


def _lagrangian(engine, pi, x, xd):
    T, V = energies(engine, pi, x, xd)
    return T - V


def omega_world(rpy, drpy):
    """World angular velocity for the rpy convention R_wb = RPY(rpy)^T."""
    R, Rd = jvp(lambda r: sp.rpy_to_rot(r).T, (rpy,), (drpy,))
    W = Rd @ R.T
    return sp.unskew(0.5 * (W - W.T))


def euler_map(rpy):
    """E(rpy) with omega_world = E @ rpy_dot."""
    return jacfwd(lambda rd: omega_world(rpy, rd))(torch.zeros_like(rpy))


def inverse_dynamics_fixed(engine: DynamicsEngine, pi, q, dq, ddq):
    """Fixed-base joint torques from the Euler-Lagrange equations."""
    z = torch.zeros(6, dtype=q.dtype, device=q.device)
    x = torch.cat([z, q])
    xd = torch.cat([z, dq])
    xdd = torch.cat([z, ddq])
    gen = _generalized_forces(engine, pi, x, xd, xdd)
    return gen[6:]


def inverse_dynamics_floating(
    engine: DynamicsEngine, pi, q, dq, ddq, rpy, drpy, ddrpy, dpb, ddpb
):
    """Floating-base [base wrench (mixed, world origin); joint torques].

    Base position is pinned to the world origin (as everywhere in this
    toolkit); base linear velocity/acceleration dpb/ddpb are free.
    The moment conjugate to rpy-rates is mapped back to the mixed base
    moment via the transpose of the Euler-rate map (power equivalence).
    """
    x = torch.cat([torch.zeros(3, dtype=q.dtype, device=q.device), rpy, q])
    xd = torch.cat([dpb, drpy, dq])
    xdd = torch.cat([ddpb, ddrpy, ddq])
    gen = _generalized_forces(engine, pi, x, xd, xdd)
    f_base = gen[:3]
    E = euler_map(rpy)
    n_base = torch.linalg.solve(E.T, gen[3:6])
    return torch.cat([f_base, n_base, gen[6:]])


def _generalized_forces(engine, pi, x, xd, xdd):
    """d/dt dL/dxd - dL/dx: forward-over-reverse (the time derivative of
    dL/dxd along (xd, xdd)) and a reverse gradient."""
    engine._c(x.dtype, x.device)
    dLdxd = grad(lambda a, b: _lagrangian(engine, pi, a, b), argnums=1)
    _, dt_p = jvp(dLdxd, (x, xd), (xd, xdd))
    dLdx = grad(lambda a, b: _lagrangian(engine, pi, a, b), argnums=0)(x, xd)
    return dt_p - dLdx
