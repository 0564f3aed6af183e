"""Recordings the benchmark makes from its seed: joint states, base motion,
contact wrenches and measured torques, all from the reference's dynamics.

`make(robot, traffic, seed, index, device)` returns one recording as the
measurement dict the identification toolkit reads (`Data.init_from_data`).
A traffic file names the generator ("recording") and its parameters. The
same seed and index give the same recording; `index` tells apart the
recordings of one run, which all have the traffic's sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import rigid_body as rb

CHUNK = 4096  # samples per reference pass on the device


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(index)])


def _dynamics(robot, Q, V, A, base, traffic, device):
    """Inverse dynamics rows (N, rows) of the URDF's parameters, friction of
    its <dynamics> tags included when the traffic's options identify it."""
    opts = traffic["options"]
    out = []
    for s in range(0, Q.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        t = lambda a: torch.as_tensor(a[sl], dtype=torch.float64, device=device)  # noqa: E731
        b = None if base is None else tuple(t(a) for a in base)
        tau = rb.regressor(robot, t(Q), t(V), t(A), b) @ torch.as_tensor(
            robot.params.ravel(), dtype=torch.float64, device=device)
        if opts.get("identifyFrictionSimultaneously", 0):
            fb = 0 if base is None else 6
            x = np.concatenate([robot.friction, robot.damping, np.zeros(robot.num_dofs)])
            tau = tau + rb.friction_columns(t(V), opts["frictionSignThreshold"], fb) @ torch.as_tensor(
                x, dtype=torch.float64, device=device)
        out.append(tau.cpu().numpy())
    return np.concatenate(out)


def _multi_harmonic(t, mid, amp0, rng, n_harm=3, base_hz=0.3):
    """A few random harmonics per joint, amplitude tapered 1/k."""
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


def _base_R(rpy):
    return rb.rpy_matrix_t(rpy).transpose(-1, -2)


def _base_twist(rpy, rpy_d, rpy_dd):
    """World angular velocity and acceleration of world_R_base = RPY(rpy)^T:
    minus the body angular velocity of RPY(rpy) = Rz(y) Ry(p) Rx(r), and
    its time derivative."""
    (r, p, y), (rd, pd, yd), (rdd, pdd, ydd) = (a.T for a in (rpy, rpy_d, rpy_dd))
    sr, cr, sp, cp = np.sin(r), np.cos(r), np.sin(p), np.cos(p)
    wb = np.stack([rd - yd * sp, pd * cr + yd * cp * sr, -pd * sr + yd * cp * cr], axis=1)
    dwb = np.stack([
        rdd - ydd * sp - yd * pd * cp,
        pdd * cr - pd * rd * sr + ydd * cp * sr - yd * pd * sp * sr + yd * rd * cp * cr,
        -pdd * sr - pd * rd * cr + ydd * cp * cr - yd * pd * sp * cr - yd * rd * cp * sr,
    ], axis=1)
    return -wb, -dwb


def walking(robot, traffic, seed, index, device):
    """A walking-style floating-base recording: multi-harmonic joint motion,
    a base sway, vertical load alternating between the two feet with small
    tangential forces and moments. The draws follow the order of the
    toolkit's walking scenario. Measured joint torques hold the contact
    contribution J^T w of the true wrenches; the stored wrenches and the
    torques carry independent Gaussian noise; the base rows hold the net
    base wrench."""
    N, freq = int(traffic["samples"]), float(traffic["frequency"])
    rng = _rng(seed, index)
    t = np.arange(N) / freq
    lo = np.where(np.isfinite(robot.lower), robot.lower, -np.pi)
    hi = np.where(np.isfinite(robot.upper), robot.upper, np.pi)
    Q, V, A = _multi_harmonic(t, 0.5 * (lo + hi), 0.5 * (hi - lo), rng)

    f_sway = np.array([0.9, 0.6, 0.45])
    arg = 2 * np.pi * f_sway[None, :] * t[:, None] + (rng.random(3) * 2 * np.pi)[None, :]
    rpy = 0.06 * np.sin(arg)
    rpy_d = 0.06 * 2 * np.pi * f_sway * np.cos(arg)
    rpy_dd = -0.06 * (2 * np.pi * f_sway) ** 2 * np.sin(arg)
    omega, domega = _base_twist(rpy, rpy_d, rpy_dd)
    f_lin = np.array([1.1, 0.9, 1.8])
    larg = 2 * np.pi * f_lin[None, :] * t[:, None] + (rng.random(3) * 2 * np.pi)[None, :]
    pos = 0.02 * np.sin(larg)
    vlin = 0.02 * 2 * np.pi * f_lin * np.cos(larg)
    alin = -0.02 * (2 * np.pi * f_lin) ** 2 * np.sin(larg)
    BR = _base_R(torch.as_tensor(rpy)).numpy()
    BV = np.concatenate([vlin, omega], axis=1)
    BA = np.concatenate([alin, domega], axis=1)
    tau = _dynamics(robot, Q, V, A, (BR, BV, BA), traffic, device)

    Mg = 9.81 * float(robot.params[:, 0].sum())
    load = 0.5 * (1.0 + 0.7 * np.sin(2 * np.pi * 0.9 * t))
    cf = np.zeros_like(tau)
    contacts = {}
    for frame, share in zip(traffic["contact_frames"], (load, 1.0 - load)):
        w6 = np.zeros((N, 6))
        w6[:, 2] = Mg * share
        w6[:, 0] = 0.08 * Mg * share * np.sin(2 * np.pi * 1.3 * t + 1.0)
        w6[:, 1] = 0.08 * Mg * share * np.cos(2 * np.pi * 1.1 * t)
        w6[:, 3] = 0.02 * Mg * share * np.sin(2 * np.pi * 0.7 * t)
        w6[:, 4] = 0.02 * Mg * share * np.cos(2 * np.pi * 0.8 * t + 0.5)
        link = robot.link_names.index(frame)
        for s in range(0, N, CHUNK):
            d = lambda a: torch.as_tensor(a[s:s + CHUNK], dtype=torch.float64, device=device)  # noqa: E731
            cf[s:s + CHUNK] += rb.contact_torques(robot, link, d(Q), d(BR), d(w6)).cpu().numpy()
        contacts[frame] = w6 + rng.normal(0, float(traffic["wrench_noise"]), w6.shape)
    tau[:, 6:] += cf[:, 6:]
    tau = tau + rng.normal(0, float(traffic["torque_noise"]), tau.shape)
    return {
        "positions": Q, "velocities": V, "accelerations": A, "torques": tau,
        "times": t, "frequency": np.float64(freq),
        "base_rpy": rpy, "base_position": pos, "base_velocity": BV, "base_acceleration": BA,
        "contacts": np.array(contacts),
    }


def random_states(robot, traffic, seed, index, device):
    """Independent random states within the joint limits (velocities within
    min(limit, 10) rad/s, accelerations within pi rad/s^2), fixed base,
    torques from the reference's inverse dynamics plus Gaussian noise."""
    N, freq = int(traffic["samples"]), float(traffic["frequency"])
    rng = _rng(seed, index)
    n = robot.num_dofs
    vl = np.minimum(robot.velocity, 10.0)
    Q = robot.lower + (robot.upper - robot.lower) * rng.random((N, n))
    V = (rng.random((N, n)) - 0.5) * 2 * vl
    A = (rng.random((N, n)) - 0.5) * 2 * np.pi
    tau = _dynamics(robot, Q, V, A, None, traffic, device)
    tau = tau + rng.normal(0, float(traffic["torque_noise"]), tau.shape)
    return {
        "positions": Q, "velocities": V, "accelerations": A, "torques": tau,
        "times": np.arange(N) / freq, "frequency": np.float64(freq),
    }


GENERATORS = {"walking": walking, "random_states": random_states}


def make(robot, traffic, seed: int, index: int, device) -> dict:
    return GENERATORS[traffic["recording"]](robot, traffic, seed, index, device)
