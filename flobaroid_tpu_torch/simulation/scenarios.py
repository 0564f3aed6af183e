"""Synthetic measurement scenarios generated from the engine itself.

The port's copy of flobaroid_tpu/simulation/scenarios.py: a walking-style
floating-base scenario (multi-harmonic joint motion, base sway, ground
reaction wrenches alternating between the feet) whose measured arrays
satisfy the estimator's model exactly:

    Y(q, v, a) . pi_true = tau_measured_stack - J^T w

Measured JOINT torques contain the contact contribution; the measured
BASE wrench rows are the net base wrench (Y pi)_b, to which
computeRegressors adds (J^T w)_b. The random draws come from numpy's
`default_rng(seed)` in the JAX function's order, so one seed gives the
same samples in both packages; the inverse dynamics and the contact
Jacobians run on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from ..dynamics import spatial as sp

__all__ = ["walking_contact_scenario", "twist_from_rpy_series"]


def _world_R_base(r):
    return sp.rpy_to_rot(r).transpose(-1, -2)  # the npz storage convention


def twist_from_rpy_series(rpy, rpy_d, rpy_dd):
    """Exact world angular velocity/acceleration of the base for an
    analytic base_rpy series under the storage convention
    world_R_base = RPY(rpy)^T: omega satisfies dR_wb/dt = S(omega) R_wb,
    domega is its time derivative. Forward-mode derivatives through the
    rotation map itself, in f64 on the CPU."""

    def omega_of(r, rd):
        R = _world_R_base(r)
        _, Rd = jvp(_world_R_base, (r,), (rd,))
        W = Rd @ R.transpose(-1, -2)
        return sp.unskew(0.5 * (W - W.transpose(-1, -2)))

    def both(r, rd, rdd):
        return jvp(omega_of, (r, rd), (rd, rdd))

    args = [torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in (rpy, rpy_d, rpy_dd)]
    w, dw = vmap(both)(*args)
    return w.numpy(), dw.numpy()


def _multi_harmonic(t, mid, amp0, rng, n_harm=3, base_hz=0.3):
    """Smooth per-joint motion with analytic derivatives: a few random
    harmonics, amplitude-tapered 1/k, total excursion <= 0.55 * amp0."""
    N, nd = len(t), len(mid)
    Q = np.tile(mid, (N, 1))
    V = np.zeros((N, nd))
    A = np.zeros((N, nd))
    for k in range(1, n_harm + 1):
        w = 2 * np.pi * (base_hz * k + 0.2 * rng.random(nd))
        ph = rng.random(nd) * 2 * np.pi
        a_k = 0.3 * amp0 / k
        arg = w[None, :] * t[:, None] + ph[None, :]
        Q += a_k * np.sin(arg)
        V += a_k * w * np.cos(arg)
        A += -a_k * w**2 * np.sin(arg)
    return Q, V, A


def walking_contact_scenario(
    model,
    N: int = 4000,
    freq: float = 200.0,
    seed: int = 0,
    contact_frames=("L_foot_ft", "R_foot_ft"),
    torque_noise: float = 0.0,
    wrench_noise: float = 0.0,
    imu: bool = False,
    n_harm: int = 3,
    amp_scale: float = 1.0,
):
    """Build a walking-style contact identification scenario for a
    floating-base port Model.

    Returns (samples, tau_full, cf_true): a measurements dict ready for
    ``Data.init_from_data``/``np.savez`` (full (N, 6+nd) torques, a
    ``contacts`` dict npz object with one (N, 6) wrench per frame), the
    noise-free inverse-dynamics rows of the generating model, and the
    true contact torque contribution J^T w. Torque noise and F/T noise
    are independent: the TRUE wrench shapes the measured joint torques,
    the stored ``contacts`` carry the noisy F/T reading. n_harm and
    amp_scale shape the excitation (the defaults are well excited;
    n_harm=1 with a small amp_scale is the barely excited regime of real
    walking logs).
    """
    nd = model.num_dofs
    if not model.opt.get("floatingBase", 0):
        raise ValueError("walking_contact_scenario needs floatingBase=1")
    rng = np.random.default_rng(seed)
    t = np.arange(N) / freq

    lims = model.limits
    jn = model.jointNames
    lo = np.array([lims[j]["lower"] for j in jn])
    hi = np.array([lims[j]["upper"] for j in jn])
    lo = np.where(np.isfinite(lo), lo, -np.pi)
    hi = np.where(np.isfinite(hi), hi, np.pi)
    Q, V, A = _multi_harmonic(
        t, 0.5 * (lo + hi), amp_scale * 0.5 * (hi - lo), rng, n_harm=n_harm
    )

    # base sway: a small rpy oscillation, its twist derived through the
    # storage convention, so an rpy<->twist convention fault in the
    # estimator shows up as a parameter-recovery failure
    f_sway = np.array([0.9, 0.6, 0.45])
    ph_sway = rng.random(3) * 2 * np.pi
    arg = 2 * np.pi * f_sway[None, :] * t[:, None] + ph_sway[None, :]
    rpy = 0.06 * np.sin(arg)
    rpy_d = 0.06 * 2 * np.pi * f_sway * np.cos(arg)
    rpy_dd = -0.06 * (2 * np.pi * f_sway) ** 2 * np.sin(arg)
    omega, domega = twist_from_rpy_series(rpy, rpy_d, rpy_dd)
    f_lin = np.array([1.1, 0.9, 1.8])
    ph_lin = rng.random(3) * 2 * np.pi
    larg = 2 * np.pi * f_lin[None, :] * t[:, None] + ph_lin[None, :]
    pos = 0.02 * np.sin(larg)
    vlin = 0.02 * 2 * np.pi * f_lin * np.cos(larg)
    alin = -0.02 * (2 * np.pi * f_lin) ** 2 * np.sin(larg)

    samples = {
        "positions": Q,
        "velocities": V,
        "accelerations": A,
        "torques": np.zeros((N, 6 + nd)),
        "times": t,
        "frequency": np.float64(freq),
        "base_rpy": rpy,
        "base_position": pos,
        "base_velocity": np.concatenate([vlin, omega], axis=1),
        "base_acceleration": np.concatenate([alin, domega], axis=1),
    }
    if imu:
        # body-frame IMU readings consistent with the base motion: gyro
        # R_wb^T omega_w, accelerometer R_wb^T (a_w - g), orientation
        # IMUrpy in the DIRECT convention world_R_imu = RPY(IMUrpy)
        R_wb = _world_R_base(torch.as_tensor(rpy, dtype=torch.float64))
        samples["IMUrpy"] = sp.rot_to_rpy(R_wb).numpy()
        R_wb = R_wb.numpy()
        g_vec = np.array([0.0, 0.0, -9.81])
        samples["IMUrotVel"] = np.einsum("nji,nj->ni", R_wb, omega)
        samples["IMUlinAcc"] = np.einsum("nji,nj->ni", R_wb, alin - g_vec[None, :])
    idx = np.arange(N)
    tau_full = model.simulate_dynamics(samples, idx)  # (N, 6+nd) incl. friction

    # ground-reaction-style wrenches: vertical load alternating between
    # the feet around half the body weight, small tangential forces and
    # moments (walking single/double-support rhythm)
    Mg = 9.81 * float(np.sum(model.xStdModel[: model.num_model_params : 10]))
    step = 2 * np.pi * 0.9 * t
    load = 0.5 * (1.0 + 0.7 * np.sin(step))
    shares = [load, 1.0 - load]

    Qs, _, _, BR, _, _ = model._gather_state(samples, idx)
    cf_true = np.zeros((N, 6 + nd))
    contacts = {}
    for frame, share in zip(contact_frames, shares):
        li = model.tree.link_index.get(str(frame))
        if li is None:
            raise KeyError(f"contact frame {frame!r} not in the model")
        w6 = np.zeros((N, 6))
        w6[:, 2] = Mg * share
        w6[:, 0] = 0.08 * Mg * share * np.sin(2 * np.pi * 1.3 * t + 1.0)
        w6[:, 1] = 0.08 * Mg * share * np.cos(2 * np.pi * 1.1 * t)
        w6[:, 3] = 0.02 * Mg * share * np.sin(2 * np.pi * 0.7 * t)
        w6[:, 4] = 0.02 * Mg * share * np.cos(2 * np.pi * 0.8 * t + 0.5)
        Jt = model._contact_jacobians(li, Qs, BR)  # (N, 6+nd, 6) J^T
        cf_true += np.einsum("nkc,nc->nk", Jt, w6)
        w_meas = w6
        if wrench_noise > 0:
            w_meas = w6 + rng.normal(0, wrench_noise, w6.shape)
        contacts[str(frame)] = w_meas

    torq = tau_full.copy()
    torq[:, 6:] += cf_true[:, 6:]
    if torque_noise > 0:
        torq = torq + rng.normal(0, torque_noise, torq.shape)
    samples["torques"] = torq
    samples["contacts"] = np.array(contacts)
    return samples, tau_full, cf_true
