"""Excitation trajectory families.

Counterpart of flobaroid_tpu/excitation/trajectory.py (reference
excitation/trajectoryGenerator.py): Swevers-1997 finite Fourier series
per joint, the tanh-squashed bounded variant that keeps URDF position
limits by construction with analytic derivatives, array playback, static
postures and minimum-jerk quintic transitions.

`fourier_traj` evaluates all joints, samples and candidates as one
differentiable torch expression over flat parameter vectors: a vector
`x` of shape (dim,) gives (N, n) arrays, a population `x` of shape
(K, dim) gives (K, N, n). The ragged per-joint harmonics are gathered
once into a zero-padded (n, max nf) table, so the series is two batched
matrix products whatever the joint count. The class wrappers keep the
reference's object API and its npz parameter layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.tensor_ops import clip


def minimum_jerk_transition(q_start, q_end, duration, freq):
    """Quintic minimum-jerk transition (reference trajectoryGenerator.py:11-44)."""
    n = max(int(duration * freq), 2)
    times = np.arange(n) / freq
    T = times[-1]
    tau = times / T
    s = 10 * tau**3 - 15 * tau**4 + 6 * tau**5
    ds = (30 * tau**2 - 60 * tau**3 + 30 * tau**4) / T
    dds = (60 * tau - 180 * tau**2 + 120 * tau**3) / T**2
    delta = np.asarray(q_end) - np.asarray(q_start)
    return (
        times,
        np.asarray(q_start)[None, :] + np.outer(s, delta),
        np.outer(ds, delta),
        np.outer(dds, delta),
    )


@dataclass(frozen=True)
class FourierSpec:
    """Static structure of a Fourier trajectory parameter vector.

    Flat layout [wf, q0 (n), a (sum nf), b (sum nf)] matching the
    reference's optimizer variable vector (trajectoryOptimizer.py:175).
    """

    nf: tuple[int, ...]  # harmonics per joint
    limits: tuple[tuple[float, float], ...] | None = None  # bounded mode

    @property
    def num_dofs(self):
        return len(self.nf)

    @property
    def dim(self):
        return 1 + self.num_dofs + 2 * sum(self.nf)

    def split(self, x):
        n = self.num_dofs
        wf = x[0]
        q0 = x[1 : 1 + n]
        tot = sum(self.nf)
        a = x[1 + n : 1 + n + tot]
        b = x[1 + n + tot : 1 + n + 2 * tot]
        return wf, q0, a, b

    def join(self, wf, q0, a_list, b_list):
        return np.concatenate(
            [[wf], np.asarray(q0, dtype=float)]
            + [np.asarray(ai, dtype=float) for ai in a_list]
            + [np.asarray(bi, dtype=float) for bi in b_list]
        )

    def ragged(self, x):
        """-> (wf, q0, [a_i], [b_i]) with per-joint coefficient arrays."""
        wf, q0, a, b = self.split(np.asarray(x))
        offs = np.concatenate([[0], np.cumsum(self.nf)]).astype(int)
        a_list = [a[offs[i] : offs[i + 1]] for i in range(self.num_dofs)]
        b_list = [b[offs[i] : offs[i + 1]] for i in range(self.num_dofs)]
        return wf, q0, a_list, b_list


def _harmonic_table(spec: FourierSpec):
    """(index, mask) of shape (n, max nf): positions of joint j's
    coefficients inside the flat a / b blocks, zero-masked padding."""
    n, F = spec.num_dofs, max(spec.nf)
    idx = np.zeros((n, F), dtype=np.int64)
    mask = np.zeros((n, F))
    off = 0
    for j, nf in enumerate(spec.nf):
        idx[j, :nf] = off + np.arange(nf)
        mask[j, :nf] = 1.0
        off += nf
    return idx, mask


def fourier_traj(spec: FourierSpec, x, times):
    """Evaluate the trajectory: returns (Q, V, A) with shape (N, n) for
    one parameter vector x (dim,), or (K, N, n) for a population (K, dim).

    Classic mode (reference OscillationGenerator:411-459):
        q = sum_l a_l/(wf l) sin(wf l t) - b_l/(wf l) cos(wf l t) + nf*q0
    Bounded mode (BoundedOscillationGenerator:462-558):
        q = q_center + q_range * tanh(raw), raw = sum a sin + b cos,
        with q_center = clip(mid + q0, lo, hi) and
        q_range = 0.95 * min(center-lo, hi-center).
    Differentiable in x; follows the dtype and device of x.
    """
    single = x.ndim == 1
    X = x[None] if single else x
    kw = dict(dtype=X.dtype, device=X.device)
    n = spec.num_dofs
    tot = sum(spec.nf)
    wf = X[:, 0]
    q0 = X[:, 1 : 1 + n]
    a = X[:, 1 + n : 1 + n + tot]
    b = X[:, 1 + n + tot : 1 + n + 2 * tot]
    idx, mask = _harmonic_table(spec)
    idx = torch.as_tensor(idx, device=X.device)
    mask = torch.as_tensor(mask, **kw)
    Aj = a[:, idx] * mask  # (K, n, F)
    Bj = b[:, idx] * mask
    times = torch.as_tensor(np.asarray(times, dtype=float), **kw) \
        if not isinstance(times, torch.Tensor) else times.to(**kw)
    l = torch.arange(1, idx.shape[1] + 1, **kw)
    wl = wf[:, None] * l  # (K, F)
    wlt = times[None, :, None] * wl[:, None, :]  # (K, N, F)
    s, c = torch.sin(wlt), torch.cos(wlt)
    wl_ = wl[:, None, :]  # against (K, n, F)

    def series(sin_coef, cos_coef):  # (K, n, F) each -> (K, N, n)
        return s @ sin_coef.transpose(1, 2) + c @ cos_coef.transpose(1, 2)

    if spec.limits is not None:
        lim = torch.as_tensor(np.asarray(spec.limits, dtype=float), **kw)
        lo, hi = lim[:, 0], lim[:, 1]
        raw = series(Aj, Bj)
        th = torch.tanh(raw)
        sech2 = 1.0 - th**2
        center = clip(0.5 * (lo + hi) + q0, lo, hi)[:, None, :]
        rng = torch.minimum(center - lo, hi - center) * 0.95
        raw_d = series(-Bj * wl_, Aj * wl_)
        raw_dd = series(-Aj * wl_**2, -Bj * wl_**2)
        Q = center + rng * th
        V = rng * sech2 * raw_d
        A = rng * (sech2 * raw_dd - 2.0 * th * sech2 * raw_d**2)
    else:
        nf = torch.as_tensor(np.asarray(spec.nf, dtype=float), **kw)
        Q = series(Aj / wl_, -Bj / wl_) + (nf * q0)[:, None, :]
        V = series(Bj, Aj)
        A = series(-Aj * wl_, Bj * wl_)
    return (Q[0], V[0], A[0]) if single else (Q, V, A)


# ----------------------------------------------------------------------
# reference-compatible object API
# ----------------------------------------------------------------------
class Trajectory:
    def getAngle(self, dof):
        raise NotImplementedError

    def getVelocity(self, dof):
        raise NotImplementedError

    def getAcceleration(self, dof):
        raise NotImplementedError

    def getPeriodLength(self):
        raise NotImplementedError

    def setTime(self, time):
        raise NotImplementedError

    def wait_for_zero_vel(self, t_elapsed):
        raise NotImplementedError


class PulsedTrajectory(Trajectory):
    """Fourier-series trajectory over all joints
    (reference trajectoryGenerator.py:273-408)."""

    def __init__(self, dofs: int, use_deg: bool = False):
        self.dofs = dofs
        self.use_deg = use_deg
        self.w_f_global = 1.0
        self.joint_limits = None
        self.time = 0.0

    def initWithRandomParams(self, rng=None):
        rng = rng or np.random.default_rng()
        nf = rng.integers(1, 4, self.dofs)
        q = rng.random(self.dofs) * 2 - 1
        a, b = [], []
        for i in range(self.dofs):
            mx = 2.0 - abs(q[i])
            a.append(rng.random(nf[i]) * mx - mx / 2)
            b.append(rng.random(nf[i]) * mx - mx / 2)
        if self.use_deg:
            q = np.rad2deg(q)
        return self.initWithParams(a, b, q, nf)

    def initWithParams(self, a, b, q, nf, wf=None, joint_limits=None):
        if len(nf) != self.dofs or len(q) != self.dofs:
            raise ValueError("Need DOFs many values for nf and q!")
        self.a, self.b, self.q, self.nf = a, b, np.asarray(q, dtype=float), np.asarray(nf, dtype=int)
        self.joint_limits = joint_limits
        if wf:
            self.w_f_global = float(wf)
        q_rad = np.deg2rad(self.q) if self.use_deg else self.q
        self.spec = FourierSpec(
            nf=tuple(int(v) for v in self.nf),
            limits=tuple((float(l), float(h)) for l, h in joint_limits) if joint_limits else None,
        )
        self.x = self.spec.join(self.w_f_global, q_rad, a, b)
        return self

    def sample(self, times):
        """(Q, V, A) in rad over an array of times (vectorized core)."""
        Q, V, A = fourier_traj(self.spec, torch.as_tensor(self.x, dtype=torch.float64), np.asarray(times))
        return Q.numpy(), V.numpy(), A.numpy()

    def getPeriodLength(self):
        return 2 * np.pi / self.w_f_global

    def setTime(self, time):
        self.time = time

    def _point(self, dof):
        Q, V, A = self.sample(np.array([self.time]))
        conv = np.rad2deg if self.use_deg else (lambda v: v)
        return conv(Q[0, dof]), conv(V[0, dof]), conv(A[0, dof])

    def getAngle(self, dof):
        return float(self._point(dof)[0])

    def getVelocity(self, dof):
        return float(self._point(dof)[1])

    def getAcceleration(self, dof):
        return float(self._point(dof)[2])

    def wait_for_zero_vel(self, t_elapsed):
        self.setTime(t_elapsed)
        thresh = 5.0 if self.use_deg else np.deg2rad(5.0)
        return abs(self.getVelocity(0)) < thresh


class ArrayTrajectory(Trajectory):
    """Playback of pre-sampled kinematics
    (reference trajectoryGenerator.py:232-270)."""

    def __init__(self, times, positions, velocities, accelerations):
        self.times = np.asarray(times)
        self.positions = np.asarray(positions)
        self.velocities = np.asarray(velocities)
        self.accelerations = np.asarray(accelerations)
        self.num_dofs = self.positions.shape[1]
        self._idx = 0
        self.time = 0.0

    def setTime(self, time):
        self.time = time
        self._idx = int(np.clip(np.searchsorted(self.times, time), 0, len(self.times) - 1))

    def getAngle(self, dof):
        return float(self.positions[self._idx, dof])

    def getVelocity(self, dof):
        return float(self.velocities[self._idx, dof])

    def getAcceleration(self, dof):
        return float(self.accelerations[self._idx, dof])

    def getPeriodLength(self):
        return float(self.times[-1])

    def wait_for_zero_vel(self, t_elapsed):
        self.setTime(t_elapsed)
        thresh = np.deg2rad(5.0)
        return all(abs(self.getVelocity(d)) < thresh for d in range(self.num_dofs))


class FixedPositionTrajectory(Trajectory):
    """Static postures with minimum-jerk moves between them
    (reference trajectoryGenerator.py:560-698)."""

    def __init__(self, config: dict):
        self.config = config
        self.angles: list | None = None
        self.time = 0.0
        self.num_dofs = int(config["num_dofs"])
        self.posture_time = float(config.get("staticPostureTime", 0.05))
        self.move_time = float(config.get("staticPostureMoveTime", 2.0))
        # reference key (trajectory.py:161): hold-sample count per posture
        self.samples_per = config.get("simulateStaticSamplesPerPosture", None)

    def initWithAngles(self, angles):
        """angles: list of per-posture joint vectors (rad)."""
        self.angles = [np.asarray(a, dtype=float) for a in angles]
        freq = float(self.config["excitationFrequency"])
        segs_t, segs_q, segs_v, segs_a = [], [], [], []
        t_offset = 0.0
        prev = np.zeros(self.num_dofs)
        for posture in self.angles:
            tt, qq, vv, aa = minimum_jerk_transition(prev, posture, self.move_time, freq)
            segs_t.append(tt + t_offset)
            segs_q.append(qq)
            segs_v.append(vv)
            segs_a.append(aa)
            t_offset = segs_t[-1][-1] + 1.0 / freq
            n_hold = (
                max(int(self.samples_per), 1) if self.samples_per
                else max(int(self.posture_time * freq), 1)
            )
            segs_t.append(t_offset + np.arange(n_hold) / freq)
            segs_q.append(np.tile(posture, (n_hold, 1)))
            segs_v.append(np.zeros((n_hold, self.num_dofs)))
            segs_a.append(np.zeros((n_hold, self.num_dofs)))
            t_offset = segs_t[-1][-1] + 1.0 / freq
            prev = posture
        self._array = ArrayTrajectory(
            np.concatenate(segs_t),
            np.concatenate(segs_q),
            np.concatenate(segs_v),
            np.concatenate(segs_a),
        )
        return self

    def setTime(self, time):
        self._array.setTime(time)

    def getAngle(self, dof):
        return self._array.getAngle(dof)

    def getVelocity(self, dof):
        return self._array.getVelocity(dof)

    def getAcceleration(self, dof):
        return self._array.getAcceleration(dof)

    def getPeriodLength(self):
        return self._array.getPeriodLength()

    def wait_for_zero_vel(self, t_elapsed):
        return self._array.wait_for_zero_vel(t_elapsed)
