"""Log-barrier interior-point solver for the physical-consistency
programs, on torch tensors in f64 on the model's device.

Port of the quadratic solver of flobaroid_tpu/identification/conic.py
(see its docstring for the method: primal barrier path following with
damped Newton steps over linear inequalities and stacked affine PSD
blocks M_k(x) = F0[k] + sum_i x_i F[k, i], analytic barrier gradient and
Hessian over each block's active columns, a 40-point ray line search,
a proximal phase-I, and a free-riding KKT certificate).

What differs from the JAX module:
  * a failed Cholesky factor (a non-PD block or Newton matrix) is read
    from `torch.linalg.cholesky_ex`'s `info` and mapped to NaN per
    candidate, as jnp.linalg.cholesky's NaN output was: the barrier value
    and the line search stay branch-free and never sync per candidate;
  * the scatter-adds are `index_add_` / `index_put_(accumulate=True)`;
  * the affine PSD maps are probed with numpy in f64 as M(0) and
    M(e_i) - M(0) (exact for affine maps) instead of jacfwd;
  * a centering stage is a Python loop over Newton steps with one host
    read per step (the stopping test), not a lax.while_loop;
  * the explicit certification rung runs whenever no candidate qualifies
    for 'optimal', not only when no stage reached the quadratic zone:
    a stage can end at lam < 0.25 on a rung too low for its gap bound,
    and the JAX policy then reported 'optimal_inexact' without trying
    (seen on the 7-DOF arm at 60 000 samples, where the outcome flipped
    with the last bits of the f32 Gram).
The geometric (log-det) objective and `barrier_minimize`/`solve` are not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class BarrierProblem:
    """minimize f(x) s.t. A x <= b and M_k(x) >> eps*I."""

    objective: Callable  # x -> scalar (convex)
    A: np.ndarray | None = None  # (m, n)
    b: np.ndarray | None = None  # (m,)
    psd_maps: list[Callable] = field(default_factory=list)  # x -> (d,d) affine
    psd_eps: float = 1e-6
    obj_hess_const: np.ndarray | None = None  # constant objective Hessian


_LS_STEPS = 0.5 ** np.arange(40)
_F64 = torch.float64


class _CertTracker:
    """Best-certificate tracker: collects (x, lam, t) candidates from
    cleanly-converged centerings and keeps the one with the best status
    qualification, then tightest self-concordant bound (thresholds match
    _certificate_status)."""

    def __init__(self, nu, f0_scale, x, t):
        self.nu, self.f0 = float(nu), float(f0_scale)
        self.x, self.lam, self.t = x, np.inf, float(t)

    def _bound(self, lam, t):
        return (self.nu + np.sqrt(self.nu) * lam) / t

    def _qualifies(self, lam, t):
        # what _certificate_status needs for 'optimal'
        return lam < 0.25 and self._bound(lam, t) < 1e-3 * self.f0

    def offer(self, x, dec, t):
        dec_v = float(dec) if np.isfinite(float(dec)) else np.inf
        lam = float(np.sqrt(max(dec_v, 0.0)))
        if not np.isfinite(lam) or lam >= 1.0:
            return
        q_new, q_cur = self._qualifies(lam, t), self._qualifies(self.lam, self.t)
        if q_new != q_cur:
            if not q_new:
                return
        elif np.isfinite(self.lam) and self._bound(lam, t) >= self._bound(self.lam, self.t):
            return
        self.x, self.lam, self.t = x, lam, float(t)


def _certificate_status(nu, t, t_cert, lam_cert, f0_scale):
    """'optimal' needs the self-concordant bound (nu + sqrt(nu) lam)/t_cert
    under 1e-3*f0 AND a quadratic-zone decrement (lam < 0.25); gap met
    but uncentred maps to 'optimal_inexact'."""
    gap = nu / t
    cert_gap = (nu + np.sqrt(nu) * lam_cert) / t_cert if lam_cert < 1.0 else np.inf
    if cert_gap < 1e-3 * f0_scale and lam_cert < 0.25:
        status = "optimal"
    elif gap < 1e-3 * f0_scale:
        status = "optimal_inexact"
    else:
        status = "max_iter"
    return gap, cert_gap, status


def stack_affine_psd(psd_maps, n: int):
    """Probe affine maps x -> (d,d) (numpy, f64) into stacked arrays
    grouped by block size: [(F0 (K,d,d), F (K,d,d,n)), ...]. The maps are
    affine, so F[..., i] = M(e_i) - M(0) is exact."""
    if not psd_maps:
        return []
    zeros = np.zeros(n)
    by_d: dict[int, list[Callable]] = {}
    for M in psd_maps:
        by_d.setdefault(int(np.asarray(M(zeros)).shape[0]), []).append(M)
    eye = np.eye(n)
    groups = []
    for _, maps in sorted(by_d.items()):
        F0 = np.stack([np.asarray(M(zeros), dtype=np.float64) for M in maps])
        F = np.stack(
            [np.stack([np.asarray(M(eye[i]), dtype=np.float64) for i in range(n)], axis=-1)
             for M in maps]) - F0[..., None]
        groups.append((F0, F))
    return groups


def _logdet_or_nan(M):
    """log det of a batch of SPD matrices via Cholesky; NaN for a matrix
    whose factorization fails (no host sync)."""
    L, info = torch.linalg.cholesky_ex(M)
    ld = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
    return torch.where(info == 0, ld, torch.full_like(ld, float("nan")))


class _BarrierCore:
    """Analytic barrier value / gradient / Hessian over linear
    inequalities + stacked affine PSD groups, as f64 tensors on one
    device. Blocks are evaluated over their active columns only (each
    inertia block touches ~10 of the n decision variables), and sparse
    inequality rows the same way."""

    def __init__(self, A, b, groups, psd_eps, n, device):
        self.device = device
        A = None if A is None or len(A) == 0 else np.asarray(A, np.float64)
        self.n = n

        def t(a, dtype=_F64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.groups = []
        for F0, F in groups:
            F0s = F0 - psd_eps * np.eye(F0.shape[-1])[None, :, :]
            K = F.shape[0]
            act = [np.nonzero(np.any(F[k] != 0.0, axis=(0, 1)))[0] for k in range(K)]
            nv = max((len(a) for a in act), default=0)
            if nv == 0 or nv > n // 2:
                self.groups.append((t(F0s), t(F), None, None))
                continue
            idx = np.zeros((K, nv), dtype=np.int64)
            Fc = np.zeros(F.shape[:3] + (nv,), dtype=F.dtype)
            for k, a in enumerate(act):
                idx[k, : len(a)] = a
                Fc[k, :, :, : len(a)] = F[k][:, :, a]
            self.groups.append((t(F0s), t(F), t(Fc), t(idx, torch.int64)))
        self.nu = float((0 if A is None else A.shape[0])
                        + sum(F0.shape[0] * F0.shape[1] for F0, _ in groups))
        self.A = self.b = self._A_sp = None
        if A is not None:
            self.A, self.b = t(A), t(b)
            nnz = (A != 0.0).sum(axis=1)
            na = int(nnz.max()) if len(nnz) else 0
            if 0 < na <= max(8, n // 16):
                m = A.shape[0]
                aidx = np.zeros((m, na), dtype=np.int64)
                aval = np.zeros((m, na), dtype=np.float64)
                for i in range(m):
                    c = np.nonzero(A[i] != 0.0)[0]
                    aidx[i, : len(c)] = c
                    aval[i, : len(c)] = A[i, c]
                self._A_sp = (t(aval), t(aidx, torch.int64))
        self._iu = {}
        for F0, _ in groups:
            d = F0.shape[-1]
            iu = np.triu_indices(d)
            w = np.where(iu[0] == iu[1], 1.0, np.sqrt(2.0))
            self._iu[d] = (t(iu[0], torch.int64), t(iu[1], torch.int64), t(w))

    def lin(self, y):
        """(A y, [sum_i y_i F[k, i]]) — the parts of the slacks and blocks
        that are linear in y."""
        ay = None
        if self.A is not None:
            if self._A_sp is not None:
                av, ai = self._A_sp
                ay = (av * y[ai]).sum(dim=1)
            else:
                ay = self.A @ y
        Ms = []
        for _, F, Fc, idx in self.groups:
            if Fc is not None:
                Ms.append(torch.einsum("kabv,kv->kab", Fc, y[idx]))
            else:
                Ms.append(torch.einsum("kabn,n->kab", F, y))
        return ay, Ms

    def value(self, x):
        """-sum log slacks - sum logdet blocks; nan/inf when infeasible."""
        ax, Ms = self.lin(x)
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        if ax is not None:
            total = total - torch.log(self.b - ax).sum()
        for (F0, _, _, _), M in zip(self.groups, Ms):
            total = total - _logdet_or_nan(F0 + M).sum()
        return total

    def grad_hess(self, x):
        n = self.n
        g = torch.zeros(n, dtype=x.dtype, device=x.device)
        H = torch.zeros((n, n), dtype=x.dtype, device=x.device)

        def scatter(ij, gk, Hk):
            """g[ij] += gk, H[ij, ij'] += Hk (duplicates accumulate)."""
            g.index_add_(0, ij.reshape(-1), gk.reshape(-1))
            r = ij[:, :, None].expand(Hk.shape).reshape(-1)
            c = ij[:, None, :].expand(Hk.shape).reshape(-1)
            H.index_put_((r, c), Hk.reshape(-1), accumulate=True)

        if self.A is not None:
            if self._A_sp is not None:
                av, ai = self._A_sp
                si = 1.0 / (self.b - (av * x[ai]).sum(dim=1))
                scatter(ai, av * si[:, None],
                        (si**2)[:, None, None] * av[:, :, None] * av[:, None, :])
            else:
                si = 1.0 / (self.b - self.A @ x)
                g = g + self.A.T @ si
                H = H + (self.A * (si**2)[:, None]).T @ self.A
        _, Ms = self.lin(x)
        for (F0, F, Fc, idx), M in zip(self.groups, Ms):
            # whitened symmetric form: S_n = L^{-1} F_n L^{-T} gives
            #   d/dx_n   -logdet M = -tr(S_n)
            #   d2/dx_nm           =  tr(S_n S_m) = vec_sym(S_n).vec_sym(S_m)
            sparse = Fc is not None
            Fj = Fc if sparse else F
            K, d, nv = Fj.shape[0], Fj.shape[1], Fj.shape[-1]
            L, info = torch.linalg.cholesky_ex(F0 + M)
            L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
            X = torch.linalg.solve_triangular(L, Fj.reshape(K, d, d * nv), upper=False)
            Z = X.reshape(K, d, d, nv).permute(0, 2, 1, 3).reshape(K, d, d * nv)
            S = torch.linalg.solve_triangular(L, Z, upper=False)
            S = S.reshape(K, d, d, nv).permute(0, 2, 1, 3)  # (K, a, b, v), symmetric in (a, b)
            i0, i1, w = self._iu[d]
            Ws = S[:, i0, i1, :] * w[None, :, None]
            gk = -torch.diagonal(S, dim1=1, dim2=2).sum(dim=-1)  # (K, nv)
            if sparse:
                scatter(idx, gk, torch.einsum("ktv,ktw->kvw", Ws, Ws))
            else:
                Wm = Ws.reshape(-1, nv)
                g = g + gk.sum(dim=0)
                H = H + Wm.T @ Wm
        return g, H

    def feas_slack(self, x):
        """max constraint violation at x (s0 for phase-I); blocks carry
        the -eps*I shift, so >0 means infeasible for the SHIFTED cone."""
        s = torch.tensor(-np.inf, dtype=x.dtype, device=x.device)
        ax, Ms = self.lin(x)
        if ax is not None:
            s = torch.maximum(s, (ax - self.b).max())
        for (F0, _, _, _), M in zip(self.groups, Ms):
            s = torch.maximum(s, -torch.linalg.eigvalsh(F0 + M).min())
        return s


class QuadBarrierSolver:
    """Reusable barrier solver for QUADRATIC objectives over a fixed
    constraint structure; the objective (H, q) is an argument of each
    solve, so all solves sharing the constraints reuse one instance
    (and its warm start)."""

    def __init__(self, A, b, psd_maps, psd_eps, n, _groups=None, *, device):
        self.device = resolve_device(device)
        self.A = A
        self.b = b
        self.psd_maps = psd_maps
        self.psd_eps = psd_eps
        self.n = n
        self.last_info: dict | None = None
        self._groups = stack_affine_psd(psd_maps, n) if _groups is None else _groups
        self.core = _BarrierCore(A, b, self._groups, psd_eps, n, self.device)
        self._nu_val = max(self.core.nu, 1.0)
        self._steps = torch.as_tensor(_LS_STEPS, dtype=_F64, device=self.device)
        self._steps_ext = torch.cat([torch.zeros(1, dtype=_F64, device=self.device),
                                     self._steps])
        self._warm = None
        self._p1 = None

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=_F64, device=self.device)

    @staticmethod
    def _quad(x, H, q):
        return 0.5 * x @ (H @ x) + q @ x

    def _psi(self, x, t, H, q) -> float:
        return float(t * self._quad(x, H, q) + self.core.value(x))

    def _ray_barrier_vals(self, x, dx):
        """Barrier value at x + s*dx for every s of the line search (nan
        when infeasible): slacks sweep as slack0 - s*dslack, blocks as
        M0 + s*dM — no per-candidate reconstruction."""
        core, s = self.core, self._steps_ext
        ax, Ms0 = core.lin(x)
        adx, dMs = core.lin(dx)
        tot = torch.zeros_like(s)
        if ax is not None:
            sl = (core.b - ax)[None, :] - s[:, None] * adx[None, :]
            tot = tot - torch.log(sl).sum(dim=1)
        for (F0, _, _, _), M0, dM in zip(core.groups, Ms0, dMs):
            Mse = (F0 + M0)[None] + s[:, None, None, None] * dM[None]
            tot = tot - _logdet_or_nan(Mse).sum(dim=1)
        return tot

    def _newton_step(self, x, t, H, q):
        n = self.n
        gb, Hb = self.core.grad_hess(x)
        Hx_q = H @ x + q
        g = t * Hx_q + gb
        Hm = t * H + Hb
        lam = 1e-12 * torch.clamp(torch.trace(Hm) / n, min=1.0)
        # Hm is SPD (t H convex + barrier Hessian + ridge); a failed
        # factorization marks the step bad and takes the gradient instead
        L, info = torch.linalg.cholesky_ex(Hm + lam * torch.eye(n, dtype=_F64, device=x.device))
        dx = torch.cholesky_solve(-g[:, None], L)[:, 0]
        dec = -g @ dx
        bad = (info != 0) | ~torch.isfinite(dec) | (dec <= 0) | ~torch.isfinite(dx).all()
        dx = torch.where(bad, -g, dx)
        dec = torch.where(bad, g @ g, dec)
        # ray-form line search: the quadratic is exactly quadratic in the
        # step, the barrier affine maps sweep as M0 + s*dM
        steps, s = self._steps, self._steps_ext
        bvals = self._ray_barrier_vals(x, dx)
        quad_ext = (self._quad(x, H, q) + s * (dx @ Hx_q) + s**2 * (0.5 * dx @ (H @ dx)))
        vals_ext = t * quad_ext + bvals
        vals = vals_ext[1:]
        ok = torch.isfinite(vals) & (vals <= vals_ext[0] - 1e-4 * steps * dec)
        any_ok = ok.any()
        step_sel = torch.where(any_ok, steps[ok.to(torch.int8).argmax()], 0.0)
        return torch.where(any_ok, x + step_sel * dx, x), dec, any_ok, step_sel

    def _newton_run(self, x, t, H, q, tol, max_iter, stall_ratio):
        """One centering stage: Newton steps until the decrement
        converges, the line search fails (step < 1e-8), or the decrement
        stalls (ratio >= stall_ratio after the damped phase)."""
        it, dec, prev_dec, ok, step = 0, np.inf, np.inf, True, 1.0
        while (it < max_iter and ok and dec / 2.0 >= tol and step >= 1e-8
               and (it < 6 or dec <= stall_ratio * prev_dec)):
            x, dec_n, ok_n, step_n = self._newton_step(x, t, H, q)
            dec_f, ok_f, step_f = torch.stack(
                [dec_n, ok_n.to(_F64), step_n.to(_F64)]).tolist()
            prev_dec, dec, ok, step = dec, dec_f, bool(ok_f), step_f
            it += 1
        return x, it, dec, ok

    def _feas_slack(self, x) -> float:
        return float(self.core.feas_slack(x))

    def minimize(
        self,
        x0,
        H,
        q,
        const: float = 0.0,
        mu: float = 120.0,
        gap_tol: float = 1e-6,
        newton_tol: float = 1e-7,
        max_newton: int = 60,
        max_outer: int = 14,
        stop_fn=None,
        warm_start: bool = True,
    ):
        """Path following for f(x) = 0.5 x'Hx + q'x + const from a strictly
        feasible x0. Returns (x, status). A previous optimal solve on this
        structure leaves (x_last, t_last); one polish centering from there
        replaces the whole ladder when its Newton decrement certifies the
        quadratic zone for the CURRENT objective (else the cold ladder
        runs). The certificate is re-derived every time."""
        x0 = np.asarray(x0, dtype=np.float64)
        H = np.asarray(H, dtype=np.float64)
        q = np.asarray(q, dtype=np.float64)
        x = self._t(x0)
        nu = self._nu_val
        f0 = 0.5 * float(x0 @ (H @ x0)) + float(q @ x0) + const
        # normalize the quadratic to O(1) at the start: decrements, stall
        # cutoffs and the certificate lambda are absolute quantities
        obj_scale = max(1.0, abs(f0))
        Hj = self._t(H) / obj_scale
        qj = self._t(q) / obj_scale
        f0_scale = max(1.0, abs(f0 / obj_scale))
        t = max(1.0, nu / f0_scale)
        if not np.isfinite(self._psi(x, t, Hj, qj)):
            self.last_info = {"status": "infeasible_start"}
            return x0, "infeasible_start"
        t_cert_target = nu / (1e-4 * f0_scale)
        it_c = 0
        cert = _CertTracker(nu, f0_scale, x, t)

        warm = self._warm if stop_fn is None else None
        if warm_start and warm is not None:
            xw = self._t(warm[0])
            tw = float(warm[1])
            if np.isfinite(self._psi(xw, tw, Hj, qj)):
                xh, ith, dech, okh = self._newton_run(
                    xw, tw, Hj, qj, newton_tol, min(max_newton, 12), 0.95)
                lam_w = float(np.sqrt(max(float(dech), 0.0)))
                if okh and lam_w < 0.25:
                    x, t, it = xh, tw, ith
                    cert.offer(x, dech, t)
                    gap, cert_gap, status = _certificate_status(
                        nu, t, cert.t, cert.lam, f0_scale)
                    self.last_info = {
                        "gap": float(gap * obj_scale),
                        "gap_rel": float(gap / f0_scale),
                        "cert_gap_rel": float(cert_gap / f0_scale),
                        "cert_t": float(cert.t),
                        "newton_lambda": cert.lam,
                        "max_violation": self._feas_slack(x),
                        "barrier_t": float(t),
                        "polish_iters": int(it),
                        "certify_iters": 0,
                        "warm_start": True,
                        "status": status,
                    }
                    x_np = x.cpu().numpy()
                    self._warm = (x_np, float(t))
                    return x_np, status
                # stale warm point: full cold ladder from x0

        for _outer in range(max_outer):
            if nu / t < gap_tol * f0_scale:
                break
            # loose centering along the path; full precision in the polish
            stage_tol = max(newton_tol, 1e-4)
            x, it, dec, ok = self._newton_run(x, t, Hj, qj, stage_tol, max_newton, 0.95)
            if stop_fn is not None and stop_fn(x.cpu().numpy()):
                self.last_info = {"status": "stopped"}
                return x.cpu().numpy(), "stopped"
            cert.offer(x, dec, t)
            t = t * mu
        # final polish at the last t (solution quality + certificate)
        x, it, dec_f, _ = self._newton_run(x, t, Hj, qj, newton_tol, max_newton, 0.95)
        f_hi = float(self._quad(x, Hj, qj))
        cert.offer(x, dec_f, t)
        if not cert._qualifies(cert.lam, cert.t):
            # no candidate certifies 'optimal' (no stage reached the
            # quadratic zone, or the one that did sits at a rung too low
            # for its gap bound): one explicit certification at the
            # robust intermediate rung
            x_c, it_c, dec_c, _ = self._newton_run(
                x, t_cert_target, Hj, qj, newton_tol, 2 * max_newton, 2.0)
            cert.offer(x_c, dec_c, t_cert_target)
        x_cert, lam_cert, t_cert = cert.x, cert.lam, cert.t
        f_c = float(self._quad(x_cert, Hj, qj))
        x_ret = x if f_hi <= f_c else x_cert
        gap, cert_gap, status = _certificate_status(nu, t, t_cert, lam_cert, f0_scale)
        self.last_info = {
            # gaps in ORIGINAL objective units (the solve ran scaled)
            "gap": float(gap * obj_scale),
            "gap_rel": float(gap / f0_scale),
            "cert_gap_rel": float(cert_gap / f0_scale),
            "cert_t": float(t_cert),
            "newton_lambda": lam_cert,
            "max_violation": self._feas_slack(x_ret),
            "barrier_t": float(t),
            "polish_iters": int(it),
            "certify_iters": int(it_c),
            "status": status,
        }
        x_np = x_ret.cpu().numpy()
        if status == "optimal":
            self._warm = (x_np, float(t))
        return x_np, status

    # ------------------------------------------------------------------
    def _phase1_solver(self):
        """Lazily built lifted-structure solver (n+1 vars, M + s I),
        constructed from the stacked arrays (no re-probing)."""
        if self._p1 is None:
            A1 = b1 = None
            if self.A is not None and len(self.A) > 0:
                A1 = np.hstack([self.A, -np.ones((self.A.shape[0], 1))])
                b1 = self.b
            lifted = []
            for F0, F in self._groups:
                K, d = F0.shape[0], F0.shape[1]
                Fl = np.concatenate(
                    [F, np.broadcast_to(np.eye(d), (K, d, d))[..., None]], axis=-1)
                lifted.append((F0, Fl))
            self._p1 = QuadBarrierSolver(
                A1, b1, [], self.psd_eps, self.n + 1, _groups=lifted, device=self.device)
        return self._p1

    def phase1(self, x0, margin: float = 1e-8):
        """Strictly feasible point near x0 (cached lifted solver)."""
        x0 = np.asarray(x0, float)
        s0 = self._feas_slack(self._t(x0))
        if s0 <= 0:
            return x0, True
        s0 = s0 * 1.5 + 1e-6
        prox = 1e-6
        n = self.n
        H = np.zeros((n + 1, n + 1))
        H[:n, :n] = 2 * prox * np.eye(n)
        qv = np.concatenate([-2 * prox * x0, [1.0]])
        z0 = np.concatenate([x0, [s0]])
        z, _ = self._phase1_solver().minimize(
            z0, H, qv, const=float(prox * x0 @ x0 + s0),
            gap_tol=1e-6, max_outer=10,
            stop_fn=lambda z: float(z[-1]) < -margin,
        )
        return z[:-1], bool(float(z[-1]) < -1e-12)

    def solve_quadratic(self, x0, H, q, const: float = 0.0, **kw):
        """Phase-I + path following."""
        x_feas, ok = self.phase1(np.asarray(x0, float))
        if not ok:
            self.last_info = {"status": "infeasible"}
            return np.asarray(x0), "infeasible"
        return self.minimize(x_feas, H, q, const=const, **kw)
