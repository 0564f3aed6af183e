"""Differentiable excitation-trajectory objective.

Counterpart of flobaroid_tpu/excitation/objective.py (reference
TrajectoryOptimizer.objectiveFunc, excitation/trajectoryOptimizer.py:
220-554): regularized D-optimality of the base regressor Gram, soft
quality costs (torque-utilization balance and magnitude, position-range
use, per-joint peak-velocity target, x10 each) and hard limit
constraints (position with ovrPosLimit overrides, |velocity|, |torque|,
optional minimum velocity and torque-utilization), plus a hook for
collision-distance constraints.

The whole chain Fourier params -> (q, dq, ddq) -> batched regressor ->
Gram -> Cholesky -> objective/constraints is one differentiable torch
function of a population X (K, dim): the K x N samples are folded into
the engine's one sample axis, unfolded for the per-candidate Gram,
batched Cholesky and constraints. The K candidates are independent, so
`loss.sum().backward()` gives each its own gradient; Adam is written out
on the (K, dim) tensor. The computation runs on the model's device, in
`dtype` (f32 on the card with TF32 off, see device.py; f64 in the CPU
parity tests).
"""

from __future__ import annotations

import inspect
from typing import Callable

import numpy as np
import torch

from ..dynamics import spatial as sp
from ..identification.identifier import not_ported
from ..model import Model
from ..utils.tensor_ops import clip, maximum
from .trajectory import FourierSpec, fourier_traj


class TrajectoryObjective:
    def __init__(
        self,
        model: Model,
        config: dict,
        spec: FourierSpec,
        duration: float | None = None,
        yty_prior: np.ndarray | None = None,
        extra_constraints_fn: Callable | None = None,
        n_extra_constraints: int | None = None,
        dtype=torch.float32,
    ):
        if int(config.get("shardCandidates", 0) or 0) > 1:
            raise not_ported("shardCandidates > 1 (candidate sharding over devices)")
        self.model = model
        self.config = config
        self.spec = spec
        self.dtype = dtype
        self.device = model.device
        freq = float(config["excitationFrequency"])
        # sample one period of the slowest allowed pulsation unless fixed
        if duration is None:
            duration = 2 * np.pi / float(config.get("trajectoryPulseMin", 0.3))
        self.num_samples = max(int(duration * freq), 16)
        self.times = np.arange(self.num_samples) / freq

        jn = model.jointNames
        lims = model.limits
        ovr = config.get("ovrPosLimit", {}) or {}
        lo, hi = [], []
        for name in jn:
            pair = ovr.get(name)
            if pair:
                lo.append(np.deg2rad(pair[0]))
                hi.append(np.deg2rad(pair[1]))
            else:
                lo.append(lims[name]["lower"])
                hi.append(lims[name]["upper"])
        self.pos_lo = np.asarray(lo)
        self.pos_hi = np.asarray(hi)
        self.vel_lim = np.asarray([lims[n]["velocity"] for n in jn])
        self.tau_lim = np.asarray([lims[n]["torque"] for n in jn])

        self.Pb = np.asarray(model.B if config["useBasisProjection"] else model.Pb)
        self.pi_urdf = np.asarray(model.xStdModel[: model.num_model_params])
        self.yty_prior = yty_prior
        self.extra_constraints_fn = extra_constraints_fn
        # additive shift on the extra (collision) constraint values: the
        # margin-inflation knob of the mesh-verification recovery
        self._extra_shift = (
            np.zeros(n_extra_constraints, dtype=np.float64)
            if n_extra_constraints
            else np.float64(0.0)
        )
        self.fb = model.fb
        self.floating = bool(config["floatingBase"])

        # suspended base inside the objective (walkman_full scenario,
        # reference trajectoryGenerator.py:172-187): the ball-joint
        # integration is part of the differentiable chain; the
        # equilibrium start orientation is computed once at build time
        # (the reference re-searches per candidate on the host)
        self.suspended = None
        self._att_rpy0 = None
        if self.floating and config.get("floatingBaseAttachment") == "suspended":
            from .suspended import SuspendedSimulator

            self.suspended = SuspendedSimulator(
                model.tree,
                config.get("floatingBaseAttachmentFrame", "crane_ft"),
                damping=float(config.get("suspendedDamping", 2000.0)),
                device=self.device,
            )
            self._att_rpy0 = self.suspended.find_equilibrium_rpy(
                np.zeros(model.num_dofs)
            )
        # reference key: minTorqueUtilization (trajectoryOptimizer.py:135,
        # hard constraint, default 0.02 in the reference configs); the
        # minTorqueConstraint/minTorquePercentage pair is this repo's
        # explicit-gate spelling and still works
        mtu = config.get("minTorqueUtilization", None)
        if mtu is not None:
            self.min_torque_util = float(mtu)
        else:
            self.min_torque_util = (
                float(config.get("minTorquePercentage", 0.1))
                if config.get("minTorqueConstraint", 0)
                else 0.0
            )
        # minVelocityPercentage accepts a dict {jointName: fraction} for
        # per-joint HARD velocity floors (beyond the reference's scalar,
        # trajectoryOptimizer.py:318-323)
        mv = (
            config.get("minVelocityPercentage", 0.1)
            if config.get("minVelocityConstraint", 0)
            else 0.0
        )
        if isinstance(mv, dict):
            self.min_vel = np.array(
                [float(mv.get(j, 0.0)) for j in model.jointNames]
            )
        else:
            self.min_vel = float(mv)
        self._dopt_scale = None
        self._build()

    # ------------------------------------------------------------------
    def _t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self.dtype, device=self.device)

    def _build(self):
        """Constants of the chain as tensors on the model's device."""
        cfg = self.config
        names = list(self.model.jointNames)
        self._times = self._t(self.times)
        self._Pb = self._t(self.Pb)
        self._pi = self._t(self.pi_urdf)
        self._pos_lo, self._pos_hi = self._t(self.pos_lo), self._t(self.pos_hi)
        self._vel_lim, self._tau_lim = self._t(self.vel_lim), self._t(self.tau_lim)
        self._delta_frac = float(cfg.get("doptRegularization", 1e-4))
        # per-joint excitation targets (beyond the reference, whose
        # targets are scalars, trajectoryOptimizer.py:445-482): a dict
        # {jointName: value} drives weakly-excited joints individually
        tu_cfg = cfg.get("trajectoryTargetTorqueUtil", 0.25)
        vt_cfg = cfg.get("trajectoryTargetVelocity", 0.0)
        self._per_joint_util = isinstance(tu_cfg, dict)
        self._target_util = (
            self._t([float(tu_cfg.get(j, 0.25)) for j in names])
            if self._per_joint_util else float(tu_cfg))
        self._per_joint_vel = isinstance(vt_cfg, dict)
        if self._per_joint_vel:
            vt = np.array([float(vt_cfg.get(j, 0.0)) for j in names])
            self._vel_target = self._t(vt)
            self._vel_target_on = bool(np.any(vt > 0))
        else:
            self._vel_target = float(vt_cfg)
            self._vel_target_on = self._vel_target > 0
        self._fric = bool(cfg["identifyFrictionSimultaneously"])
        self._sign_thresh = float(cfg.get("frictionSignThreshold", 0.02))
        self._sym = bool(cfg["identifySymmetricVelFriction"])
        self._grav_only = bool(cfg["identifyGravityParamsOnly"])
        self._stribeck_v = float(cfg.get("stribeckVelocity", 0) or 0)
        self._keep_grav = (
            torch.as_tensor([p for p in range(10 * self.model.num_links) if p % 10 < 4],
                            device=self.device)
            if self._grav_only else None)
        self._yty = self._t(self.yty_prior) if self.yty_prior is not None else None
        self._min_vel_on = bool(np.any(np.asarray(self.min_vel) > 0))
        self._min_vel = self._t(np.ones(len(names)) * self.min_vel)
        self._att0 = self._t(self._att_rpy0) if self._att_rpy0 is not None else None
        self._dt_samp = float(self.times[1] - self.times[0])
        self._extra_takes_base = False
        if self.extra_constraints_fn is not None:
            try:
                self._extra_takes_base = (
                    len(inspect.signature(self.extra_constraints_fn).parameters) >= 3)
            except (TypeError, ValueError):
                self._extra_takes_base = False

    def _base_motion(self, Q, V, A):
        """Suspended-base series of the trajectories (K, N, n):
        (BR (K,N,3,3) world_R_base, pos (K,N,3), BV, BA (K,N,6))."""
        sus = self.suspended
        rpy_s, pos_s, vel_s = sus.simulate_core(Q, V, A, self._att0, self._dt_samp)
        acc_s = sus.acceleration_from_velocity(vel_s, self._dt_samp)
        # storage convention: world_R_base = RPY(rpy)^T
        BR = sp.rpy_to_rot(rpy_s).transpose(-1, -2)
        return BR, pos_s, vel_s, acc_s

    def _friction_blocks(self, V):
        """Smooth (differentiable) mirror of the model's identified
        friction-column layout: Fc [, Fv(|±), off [, Fs]] — gravity-only
        keeps Fc only. V: (M, n) -> (M, n, n_fric); the column count
        must match Pb's rows exactly."""
        nd = V.shape[-1]
        eye = torch.eye(nd, dtype=V.dtype, device=V.device)
        sgn = torch.tanh(V / self._sign_thresh)
        zero = torch.zeros((), dtype=V.dtype, device=V.device)
        blocks = [sgn[:, None, :] * eye]
        if not self._grav_only:
            if self._sym:
                blocks.append(V[:, None, :] * eye)
            else:
                blocks.append(torch.where(V > 0, V, zero)[:, None, :] * eye)
                blocks.append(torch.where(V < 0, V, zero)[:, None, :] * eye)
            blocks.append(eye.expand(V.shape[0], nd, nd))
            if self._stribeck_v > 0:
                blocks.append(
                    (torch.exp(-torch.abs(V) / self._stribeck_v) * sgn)[:, None, :] * eye)
        return torch.cat(blocks, dim=2)

    def _raw(self, X, extra_shift):
        """The chain for a population X (K, dim): (neg_logdet, f1, f2, f3,
        f4 (K,), g (K, n_constraints), n_observable (K,), chol_ok (K,))."""
        eng = self.model.engine
        fbr = 6 if self.floating else 0
        Q, V, A = fourier_traj(self.spec, X.to(self.dtype), self._times)  # (K, N, n)
        K, N, nd = Q.shape
        Qf, Vf, Af = (a.reshape(K * N, nd) for a in (Q, V, A))
        BR = pos_s = None
        if self.floating:
            if self.suspended is not None:
                BR, pos_s, BV, BA = self._base_motion(Q, V, A)
                Y = eng.regressor_batch(Qf, Vf, Af, BR.reshape(K * N, 3, 3),
                                        BV.reshape(K * N, 6), BA.reshape(K * N, 6))
            else:
                eye = torch.eye(3, dtype=self.dtype, device=self.device).expand(K * N, 3, 3)
                zero6 = torch.zeros((K * N, 6), dtype=self.dtype, device=self.device)
                Y = eng.regressor_batch(Qf, Vf, Af, eye, zero6, zero6)
        else:
            Y = eng.regressor_batch(Qf, Vf, Af)
        # torques from the FULL inertial block (before any gravity-only
        # column subsetting)
        tau = (Y @ self._pi).reshape(K, N, -1)
        if self._grav_only:
            Y = Y[:, :, self._keep_grav]
        # base projection YB = [Y, F] @ Pb without forming [Y, F]
        P_in = Y.shape[-1]
        rows = Y.shape[1]
        YB = Y.reshape(K, N * rows, P_in) @ self._Pb[:P_in]
        if self._fric:
            FB = self._friction_blocks(Vf) @ self._Pb[P_in:]  # (K*N, nd, nb)
            YB = YB.reshape(K, N, rows, -1)
            YB = torch.cat([YB[:, :, :fbr], YB[:, :, fbr:] + FB.reshape(K, N, nd, -1)], dim=2)
            YB = YB.reshape(K, N * rows, -1)
        G = YB.transpose(1, 2) @ YB  # (K, nb, nb)
        if self._yty is not None:
            G = G + self._yty
        # regularized -logdet via Cholesky: logdet(G + delta I) =
        # 2 sum log diag chol. lambda_max from a few power iterations,
        # differentiable through the short iteration like the JAX chain
        nb = G.shape[-1]
        v = torch.ones((K, nb, 1), dtype=G.dtype, device=G.device) / np.sqrt(nb)
        for _ in range(16):
            w = G @ v
            v = w / maximum(torch.linalg.norm(w, dim=1, keepdim=True), 1e-30)
        lam_max = maximum((v * (G @ v)).sum(dim=(1, 2)), 1e-30)
        deltav = self._delta_frac * lam_max
        eye_nb = torch.eye(nb, dtype=G.dtype, device=G.device)
        L, info = torch.linalg.cholesky_ex(G + deltav[:, None, None] * eye_nb)
        chol_ok = info == 0
        diag = L.diagonal(dim1=-2, dim2=-1)
        neg_logdet = -2.0 * torch.log(maximum(diag, 1e-300)).sum(dim=-1)
        n_observable = (diag**2 > deltav[:, None]).sum(dim=-1)  # cheap proxy

        pos_min = Q.amin(dim=1)
        pos_max = Q.amax(dim=1)
        vel_absmax = torch.abs(V).amax(dim=1)
        tau_absmax = torch.abs(tau[:, :, fbr:]).amax(dim=1)

        g = [
            self._pos_lo - pos_min,
            pos_max - self._pos_hi,
            vel_absmax - self._vel_lim,
            tau_absmax - self._tau_lim,
        ]
        if self._min_vel_on:
            g.append(self._vel_lim * self._min_vel - vel_absmax)
        if self.min_torque_util > 0:
            g.append(self._tau_lim * self.min_torque_util - tau_absmax)
        if self.extra_constraints_fn is not None:
            if self._extra_takes_base:
                # pass the simulated (swung) base poses so collision
                # constraints see the real world-frame link poses
                # (reference trajectoryOptimizer.py:356-359)
                ge = self.extra_constraints_fn(Q, BR if pos_s is not None else None, pos_s)
            else:
                ge = self.extra_constraints_fn(Q)
            g.append(ge + extra_shift.to(ge.dtype))
        g = torch.cat(g, dim=1)

        # soft costs (reference trajectoryOptimizer.py:445-499)
        util = tau_absmax / self._tau_lim
        um = util.mean(dim=1)
        f1 = torch.where(um > 0, util.std(dim=1, correction=0) / maximum(um, 1e-9),
                         torch.ones_like(um))
        if self._per_joint_util:
            # each joint must individually reach its target
            f3 = maximum(1.0 - util / maximum(self._target_util, 1e-9), 0.0).mean(dim=1)
        else:
            f3 = maximum(1.0 - um / self._target_util, 0.0)
        pos_util = (pos_max - pos_min) / (self._pos_hi - self._pos_lo)
        f2 = 1.0 - pos_util.mean(dim=1)
        f4 = torch.zeros_like(um)
        if self._vel_target_on:
            if self._per_joint_vel:
                short = maximum(1.0 - vel_absmax / maximum(self._vel_target, 1e-9), 0.0)
                f4 = torch.where(self._vel_target > 0, short, torch.zeros_like(short)).mean(dim=1)
            else:
                f4 = maximum(1.0 - vel_absmax / self._vel_target, 0.0).mean(dim=1)
        return neg_logdet, f1, f2, f3, f4, g, n_observable, chol_ok

    def _evaluate(self, X, extra_shift):
        """(f (K,), g (K, m), n_obs (K,), ok (K,)). A candidate whose
        Cholesky failed or whose f is not finite reads f = 1e4 (the JAX
        chain's NaN rule)."""
        neg_logdet, f1, f2, f3, f4, g, n_obs, ok = self._raw(X, extra_shift)
        f = neg_logdet * self.dopt_scale + 10.0 * (f1 + f3 + f4) + 10.0 * f2
        ok = ok & torch.isfinite(f)
        f = torch.where(ok, f, torch.full_like(f, 1e4))
        # preserve the SIGN of infinite constraint values: a joint
        # without a URDF limit yields vel_absmax - inf = -inf, an
        # infinitely-SATISFIED constraint
        g = torch.where(torch.isnan(g), torch.full_like(g, 10.0), clip(g, -1e6, 1e6))
        return f, g, n_obs, ok

    def _penalized(self, X, weight, extra_shift):
        f, g, _, ok = self._evaluate(X, extra_shift)
        viol = maximum(g, 0.0)
        return f + weight * (viol**2).sum(dim=1) + weight * 0.1 * viol.sum(dim=1), ok

    def _al_value(self, X, lam, rho, extra_shift):
        """Augmented Lagrangian (Rockafellar form for inequalities):
            L(x; lam, rho) = f + 1/(2 rho) * sum( max(0, lam + rho g)^2 - lam^2 )
        multiplier update (host side): lam <- max(0, lam + rho g(x)).
        Unlike the quadratic penalty, active constraints get exact
        multipliers, so feasibility does not require rho -> inf."""
        f, g, _, ok = self._evaluate(X, extra_shift)
        t = maximum(lam + rho[:, None] * g, 0.0)
        return f + (0.5 / rho) * (t**2 - lam**2).sum(dim=1), ok

    def _value_and_grad(self, fn, X):
        """Values (K,) and per-candidate gradients (K, dim) of fn over the
        K independent candidates. Non-finite gradient entries are zeroed,
        and a candidate whose Cholesky failed gets a zero gradient (in
        the JAX chain its gradient is NaN throughout, then zeroed)."""
        X = X.detach().requires_grad_(True)
        v, ok = fn(X)
        (grad,) = torch.autograd.grad(v.sum(), X)
        grad = torch.where(torch.isfinite(grad) & ok[:, None], grad, torch.zeros_like(grad))
        return v.detach(), grad

    def _adam(self, fn, X, lo, hi, lr, n_steps):
        """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, bias
        correction) on the (K, dim) tensor, then the box clip."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = torch.zeros_like(X)
        nu = torch.zeros_like(X)
        v = None
        for t in range(1, n_steps + 1):
            v, g = self._value_and_grad(fn, X)
            m = b1 * m + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * g * g
            m_hat = m / (1.0 - b1**t)
            nu_hat = nu / (1.0 - b2**t)
            X = torch.clamp(X - lr * m_hat / (torch.sqrt(nu_hat) + eps), lo, hi)
        return X, v

    # ------------------------------------------------------------------
    def set_extra_shift(self, shift) -> None:
        """Update the additive shift on the extra (collision)
        constraints — the mesh-backoff margin-inflation knob."""
        self._extra_shift = np.asarray(shift, dtype=np.float64)

    @property
    def _shift_t(self):
        return self._t(self._extra_shift)

    def _x(self, x):
        """(K, dim) tensor on the device from one vector or a population."""
        return self._t(np.atleast_2d(np.asarray(x, dtype=float)))

    def dopt(self, x):
        """Pure regularized D-optimality (-sum log eig) of a candidate —
        without soft costs or scaling (for quality reporting)."""
        with torch.no_grad():
            return float(self._raw(self._x(x), self._shift_t)[0][0])

    # ------------------------------------------------------------------
    def calibrate_scale(self, x0: np.ndarray):
        """Set the D-optimality scaling so the initial value is ~10
        (reference trajectoryOptimizer.py:288-293)."""
        v = abs(self.dopt(x0))
        self._dopt_scale = 10.0 / max(v, 1.0)
        return self._dopt_scale

    @property
    def dopt_scale(self):
        if self._dopt_scale is None:
            raise RuntimeError("call calibrate_scale(x0) first")
        return self._dopt_scale

    def evaluate(self, x):
        f, g, n_obs = self.evaluate_batch(np.asarray(x)[None])
        return float(f[0]), g[0], int(n_obs[0])

    def evaluate_batch(self, X):
        with torch.no_grad():
            f, g, n_obs, _ = self._evaluate(self._x(X), self._shift_t)
        return (f.double().cpu().numpy(), g.double().cpu().numpy(), n_obs.cpu().numpy())

    def penalized_value_and_grad(self, x, weight):
        shift = self._shift_t
        v, g = self._value_and_grad(
            lambda X: self._penalized(X, float(weight), shift), self._x(x))
        return float(v[0]), g[0].double().cpu().numpy()

    def al_value_and_grad(self, X, LAM, RHO):
        """Augmented-Lagrangian values (K,) and gradients (K, dim) of K
        candidates with their own multipliers LAM (K, m) and penalties
        RHO (K,) (the quantity one step of `al_refine_batch` descends)."""
        lam, rho, shift = self._t(LAM), self._t(RHO), self._shift_t
        v, g = self._value_and_grad(lambda X: self._al_value(X, lam, rho, shift), self._x(X))
        return v.double().cpu().numpy(), g.double().cpu().numpy()

    def adam_refine(self, x, lo, hi, weight, lr=0.01, n_steps=200):
        """One Adam run on the quadratic-penalty value on the device."""
        shift = self._shift_t
        X, v = self._adam(lambda X: self._penalized(X, float(weight), shift),
                          self._x(x), self._t(lo), self._t(hi), lr, n_steps)
        return X[0].double().cpu().numpy(), float(v[0])

    def al_refine(self, x, lo, hi, lam, rho, lr=0.01, n_steps=200):
        """One augmented-Lagrangian Adam stage on the device."""
        lam_t, rho_t, shift = self._t(lam)[None], self._t([rho]), self._shift_t
        X, v = self._adam(lambda X: self._al_value(X, lam_t, rho_t, shift),
                          self._x(x), self._t(lo), self._t(hi), lr, n_steps)
        return X[0].double().cpu().numpy(), float(v[0])

    def al_refine_batch(self, X, lo, hi, LAM, RHO, lr=0.01, n_steps=200):
        """One augmented-Lagrangian Adam stage for K independent restarts
        advanced together (the reference runs IPOPT restarts as
        sequential processes; here the restart axis is the batch axis)."""
        lam, rho, shift = self._t(LAM), self._t(RHO), self._shift_t
        Xo, _ = self._adam(lambda X: self._al_value(X, lam, rho, shift),
                           self._x(X), self._t(lo), self._t(hi), lr, n_steps)
        return Xo.double().cpu().numpy()

    def kinematics_batch(self, X):
        """Sampled (Q (K, N, n), base_rot (K, N, 3, 3), base_pos (K, N, 3))
        of K candidates X (K, dim) in f64 on the host — the same chain the
        objective runs, exposed for a dense collision verification
        (reference optimizer.py:1099-1132). The base series are None
        without a suspended base."""
        with torch.no_grad():
            Q, V, A = fourier_traj(self.spec, self._x(X), self._times)
            out = (Q, None, None)
            if self.suspended is not None:
                BR, pos_s, _, _ = self._base_motion(Q, V, A)
                out = (Q, BR, pos_s)
        return tuple(None if a is None else a.double().cpu().numpy() for a in out)

    def kinematics(self, x):
        """`kinematics_batch` of one candidate: (Q (N, n), base_rot,
        base_pos)."""
        Q, BR, BP = self.kinematics_batch(np.asarray(x, dtype=float)[None])
        return Q[0], None if BR is None else BR[0], None if BP is None else BP[0]

    def feasible(self, g, tol=None):
        """Constraint feasibility with the reference's minTolConstr
        tolerance (tanh rounding causes tiny angle violations,
        reference trajectoryOptimizer.py:573)."""
        if tol is None:
            tol = float(self.config.get("minTolConstr", 0.0) or 0.0)
        return bool(np.all(np.asarray(g) <= tol))
