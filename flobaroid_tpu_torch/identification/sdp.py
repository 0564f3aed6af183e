"""Physically consistent identification (SDP layer).

Counterpart of the reference's identification/sdp.py (Sousa 2014 LMI
approach via cvxpy/CLARABEL): per-link 6x6 spatial-inertia PSD
constraints, mass/COM boxes, COM-in-hull, symmetry pairs, friction
positivity, CAD regularization in three modes (uniform /
observability / geometric log-det Bregman divergence on whitened
pseudo-inertia), the feasible-std solve, the closest-to-CAD two-step
refinement and direct-YStd variant.

Port of flobaroid_tpu/identification/sdp.py: the constraint assembly,
the quadratic (uniform / observability CAD-regularized) feasible-std
solve, its direct-Gram variant and the closest-to-CAD refinement, with
the affine PSD maps as numpy functions and the barrier solver
(conic.QuadBarrierSolver) running in f64 on the model's device. The
geometric log-det objective is not ported yet (ROADMAP.md, queue 1).

Differences from the reference (kept from the JAX package):
  * the cvxpy Schur-complement epigraph SDP becomes a plain quadratic
    objective minimized by the log-barrier Newton solver in conic.py —
    no external conic solver,
  * exact parameter pins (dontChangeParams / noChange links) are
    eliminated from the decision space instead of encoded as equal
    upper/lower bounds (an interior-point method needs a nonempty
    interior),
  * the quadratic symmetry Schur constraint d^2 <= eps becomes the
    equivalent pair of linear bounds |d| <= sqrt(eps).

Graceful degradation matches the reference: solver failure keeps the
a-priori parameters (sdp.py:615-616).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import numpy.linalg as la
import scipy.linalg as sla

from flobaroid_tpu.models.geometry import link_bounding_box

from . import conic


def spatial_inertia_map(fixed_lookup, link: int):
    """Affine map x -> 6x6 spatial inertia [[I, S(h)^T], [S(h), m E]]
    of one link (reference sdp.py:123-148), numpy in f64."""
    entry = fixed_lookup

    def M(x):
        m = entry(x, link * 10)
        hx = entry(x, link * 10 + 1)
        hy = entry(x, link * 10 + 2)
        hz = entry(x, link * 10 + 3)
        ixx = entry(x, link * 10 + 4)
        ixy = entry(x, link * 10 + 5)
        ixz = entry(x, link * 10 + 6)
        iyy = entry(x, link * 10 + 7)
        iyz = entry(x, link * 10 + 8)
        izz = entry(x, link * 10 + 9)
        z = 0.0
        return np.array([
            [ixx, ixy, ixz, z, hz, -hy],
            [ixy, iyy, iyz, -hz, z, hx],
            [ixz, iyz, izz, hy, -hx, z],
            [z, -hz, hy, m, z, z],
            [hz, z, -hx, z, m, z],
            [-hy, hx, z, z, z, m],
        ], dtype=float)

    return M


def pseudo_inertia_map(fixed_lookup, link: int):
    """Affine map x -> 4x4 pseudo-inertia [[Sigma, h],[h^T, m]]
    (reference sdp.py:318-336), numpy in f64."""

    def P(x):
        m = fixed_lookup(x, link * 10)
        hx = fixed_lookup(x, link * 10 + 1)
        hy = fixed_lookup(x, link * 10 + 2)
        hz = fixed_lookup(x, link * 10 + 3)
        ixx = fixed_lookup(x, link * 10 + 4)
        ixy = fixed_lookup(x, link * 10 + 5)
        ixz = fixed_lookup(x, link * 10 + 6)
        iyy = fixed_lookup(x, link * 10 + 7)
        iyz = fixed_lookup(x, link * 10 + 8)
        izz = fixed_lookup(x, link * 10 + 9)
        sxx = 0.5 * (-ixx + iyy + izz)
        syy = 0.5 * (ixx - iyy + izz)
        szz = 0.5 * (ixx + iyy - izz)
        return np.array([
            [sxx, -ixy, -ixz, hx],
            [-ixy, syy, -iyz, hy],
            [-ixz, -iyz, szz, hz],
            [hx, hy, hz, m],
        ], dtype=float)

    return P


class SDP:
    def __init__(self, idf):
        self.idf = idf
        self.constr_per_param: dict[int, list[str]] = {
            p: [] for p in idf.model.identified_params
        }
        self.epsilon_safemargin = float(idf.opt.get("sdpSafeMargin", 1e-6))
        self.last_status: str | None = None
        # KKT certificate of the most recent solve: duality gap, final
        # Newton decrement, max constraint violation
        self.last_info: dict | None = None
        # persistent across initSDP_LMIs: solvers keyed by the constraint
        # STRUCTURE (repeated identifications of the same robot/options
        # reuse one solver and its warm start)
        self._solver_cache: dict = {}

    def _solver_info(self) -> dict | None:
        """Certificate of the solve that just returned."""
        s = getattr(self, "_last_solver", None)
        return getattr(s, "last_info", None)

    # ------------------------------------------------------------------
    def initSDP_LMIs(self, idf, remove_nonid: bool = True) -> None:
        """Assemble the constraint set (reference sdp.py:68-293)."""
        opt = idf.opt
        m = idf.model

        # fixed-base first-link columns dropped entirely
        if opt["floatingBase"] == 0 and opt["deleteFixedBase"]:
            dc = [0, 1, 2, 3] if opt["identifyGravityParamsOnly"] else list(range(10))
            if set(dc).issubset(set(m.non_id)):
                self.delete_cols = dc
                start_link = 1
            else:
                self.delete_cols = []
                start_link = 0
        else:
            self.delete_cols = []
            start_link = 0
        self.start_link = start_link

        self.idable_params = sorted(set(m.identified_params).difference(self.delete_cols))

        # pinned params (exact CAD equality -> eliminated from decision)
        params_to_skip: list[int] = list(opt.get("dontChangeParams", []))
        self.linkConds = None
        if opt["noChange"]:
            self.linkConds = m.getSubregressorsConditionNumbers()
            for i in range(m.num_links):
                if self.linkConds[i] > opt["noChangeThresh"]:
                    params_to_skip.extend(range(i * 10, i * 10 + 10))
        # massless virtual links (contact/attachment frames) can never
        # satisfy a PSD constraint and are structurally non-identifiable:
        # pin them to their (zero) a-priori values automatically. The
        # reference expects the user to list them in dontChangeLinks;
        # its pinned-links comment notes exactly this case (sdp.py:104-113
        # "zero-mass virtual links").
        for i in range(m.num_links):
            block = m.xStdModel[i * 10 : i * 10 + 10]
            if np.all(np.abs(block) < 1e-10):
                params_to_skip.extend(range(i * 10, i * 10 + 10))

        pinned = set()
        for p in set(params_to_skip):
            if p in self.delete_cols or p in opt["dontConstrain"]:
                continue
            if opt["identifyGravityParamsOnly"] and p in set(m.inertia_params):
                continue
            if p in self.idable_params:
                pinned.add(p)
                self.constr_per_param[p].append("cad")
        self.pinned_params = pinned

        pinned_links = set()
        for i in range(m.num_links):
            lp = set(range(i * 10, i * 10 + 10))
            if lp.issubset(pinned | set(self.delete_cols)):
                pinned_links.add(i)
        self.pinned_links = pinned_links

        # decision variables = idable minus pinned
        self.free_params = [p for p in self.idable_params if p not in pinned]
        self.pos_in_idable = {p: i for i, p in enumerate(self.idable_params)}
        self.pos_in_free = {p: i for i, p in enumerate(self.free_params)}
        fixed_vec = np.zeros(len(self.idable_params))
        scatter = np.zeros((len(self.idable_params), len(self.free_params)))
        for i, p in enumerate(self.idable_params):
            if p in pinned:
                fixed_vec[i] = m.xStdModel[p]
            else:
                scatter[i, self.pos_in_free[p]] = 1.0
        self._scatter = scatter  # x_idable = scatter @ x_free + fixed_vec
        self._fixed_vec = fixed_vec

        def lookup(x, p):
            """Value of full-parameter index p at the free vector x
            (pinned and deleted columns are fixed a priori)."""
            if p in self.pos_in_free:
                return x[self.pos_in_free[p]]
            return float(m.xStdModel[p])

        self._lookup = lookup

        # ---- PSD blocks ----
        self.psd_maps = []
        if not opt["identifyGravityParamsOnly"]:
            for i in range(start_link, m.num_links):
                if i in pinned_links:
                    continue
                self.psd_maps.append(spatial_inertia_map(lookup, i))

        # ---- linear inequalities A x_free <= b ----
        rows: list[np.ndarray] = []
        rhs: list[float] = []
        nf = len(self.free_params)

        def coef(p):
            r = np.zeros(nf)
            off = 0.0
            if p in self.pos_in_free:
                r[self.pos_in_free[p]] = 1.0
            else:
                off = m.xStdModel[p]
            return r, off

        def add_le(coeffs_offsets, bound):
            """sum(c_i * x_{p_i}) <= bound, with fixed params folded in."""
            r = np.zeros(nf)
            off = 0.0
            for c, p in coeffs_offsets:
                rp, op = coef(p)
                r += c * rp
                off += c * op
            rows.append(r)
            rhs.append(bound - off)

        if opt["identifyGravityParamsOnly"]:
            for i in range(start_link, m.num_links):
                # a pinned mass (auto-pinned massless virtual link) would
                # fold to a constant 0 <= -eps row: always infeasible
                if (i * 10 not in self.delete_cols and i not in pinned_links
                        and i * 10 not in pinned):
                    add_le([(-1.0, i * 10)], -self.epsilon_safemargin)

        robotmass_apriori = float(sum(m.xStdModel[i * 10] for i in range(m.num_links)))
        if opt["limitOverallMass"]:
            if opt["limitMassVal"]:
                maxmass = float(opt["limitMassVal"]) - float(
                    sum(m.xStdModel[i * 10] for i in range(start_link))
                )
            else:
                # the summed terms start at start_link, so the deleted
                # base link's a-priori mass must leave the bound too
                # (else the a-priori point itself violates the lower
                # bound whenever base mass > limitMassRange)
                maxmass = robotmass_apriori - float(
                    sum(m.xStdModel[i * 10] for i in range(start_link))
                )
            terms = [(1.0, i * 10) for i in range(start_link, m.num_links)]
            add_le(terms, maxmass + float(opt["limitMassRange"]))
            add_le([(-c, p) for c, p in terms], -(maxmass - float(opt["limitMassRange"])))

        if opt["limitMassToApriori"]:
            for i in range(start_link, m.num_links):
                if i in pinned_links:
                    continue
                if self.linkConds is not None and self.linkConds[i] > opt["noChangeThresh"]:
                    continue
                p = i * 10
                if p in opt["dontConstrain"] or p in pinned:
                    continue
                bound = abs(m.xStdModel[p]) * float(opt["limitMassAprioriBoundary"])
                add_le([(1.0, p)], m.xStdModel[p] + bound)
                add_le([(-1.0, p)], -(m.xStdModel[p] - bound))
                self.constr_per_param[p].append("mA")

        if opt["limitCOMToApriori"]:
            for i in range(start_link, m.num_links):
                if i in pinned_links:
                    continue
                if self.linkConds is not None and self.linkConds[i] > opt["noChangeThresh"]:
                    continue
                for p in range(i * 10 + 1, i * 10 + 4):
                    if p in opt["dontConstrain"] or p in pinned:
                        continue
                    bound = abs(m.xStdModel[p]) * float(opt["limitCOMAprioriBoundary"])
                    if abs(m.xStdModel[p]) < 0.01:
                        bound += 0.01
                    add_le([(1.0, p)], m.xStdModel[p] + bound)
                    add_le([(-1.0, p)], -(m.xStdModel[p] - bound))
                    self.constr_per_param[p].append("cA")

        self.link_hulls: dict[str, Any] = {}
        if opt["restrictCOMtoHull"]:
            for i in range(start_link, m.num_links):
                if i in pinned_links:
                    continue
                if self.linkConds is not None and self.linkConds[i] > opt["noChangeThresh"]:
                    continue
                link_name = m.linkNames[i]
                mass = m.xStdModel[i * 10]
                old_com = (
                    m.xStdModel[i * 10 + 1 : i * 10 + 4] / mass
                    if abs(mass) > 1e-10
                    else np.zeros(3)
                )
                lo, hi = link_bounding_box(
                    m.tree,
                    link_name,
                    fallback_center=old_com,
                    cube_size=float(opt["cubeSize"]),
                    scale=float(opt["hullScaling"]),
                    mesh_base_dir=str(opt["meshBaseDir"]),
                )
                self.link_hulls[link_name] = (lo, hi)
                for j in range(3):
                    p = i * 10 + 1 + j
                    if p in self.delete_cols or p in opt["dontConstrain"] or p in pinned:
                        continue
                    # m*lo_j <= l_j <= m*hi_j
                    add_le([(1.0, p), (-hi[j], i * 10)], 0.0)
                    add_le([(-1.0, p), (lo[j], i * 10)], 0.0)
                    self.constr_per_param[p].append("hull")

        if opt["useSymmetryConstraints"] and opt.get("symmetryConstraints"):
            tol = float(np.sqrt(opt["symmetryTolerance"]))
            for a, b, sign in opt["symmetryConstraints"]:
                if opt["identifyGravityParamsOnly"] and (
                    a in set(m.inertia_params) or b in set(m.inertia_params)
                ):
                    continue
                if a not in self.pos_in_free and b not in self.pos_in_free:
                    # both pinned: folds to a constant row that is
                    # infeasible whenever the a-priori values break the
                    # symmetry — no decision variable is involved
                    continue
                add_le([(1.0, a), (-sign, b)], tol)
                add_le([(-1.0, a), (sign, b)], tol)
                self.constr_per_param[a].append("sym")
                self.constr_per_param[b].append("sym")

        if opt["identifyFrictionSimultaneously"] and not opt["identifyGravityParamsOnly"]:
            nd = m.num_dofs
            for i in range(nd):
                p_fv = m.num_model_params + nd + i
                if p_fv in self.idable_params and p_fv not in pinned:
                    add_le([(-1.0, p_fv)], -self.epsilon_safemargin)
                    self.constr_per_param[p_fv].append(">0")
                if not opt["identifySymmetricVelFriction"]:
                    p_fv2 = m.num_model_params + 2 * nd + i
                    if p_fv2 in self.idable_params and p_fv2 not in pinned:
                        add_le([(-1.0, p_fv2)], -self.epsilon_safemargin)
                        self.constr_per_param[p_fv2].append(">0")
            if opt.get("stribeckVelocity", 0) > 0:
                for i in range(nd):
                    p_fs = m.num_all_params - nd + i
                    if p_fs in self.idable_params and p_fs not in pinned:
                        add_le([(-1.0, p_fs)], -self.epsilon_safemargin)
                        self.constr_per_param[p_fs].append(">0")

        self.A = np.asarray(rows) if rows else None
        self.b = np.asarray(rhs) if rhs else None

    def _structure_key(self):
        return (
            tuple(self.free_params),
            tuple(sorted(self.pinned_params)),
            self.start_link,
            None if self.A is None else hash(self.A.tobytes()),
            None if self.b is None else hash(self.b.tobytes()),
            hash(self._fixed_vec.tobytes()),
        )

    def _get_solver(self, A=None, b=None):
        # A and b are baked into the compiled barrier: both are in the key
        if A is None:
            key = ("main", self._structure_key())
        else:
            key = ("ext", self._structure_key(), hash(A.tobytes()), hash(b.tobytes()))
        if key not in self._solver_cache:
            self._solver_cache[key] = conic.QuadBarrierSolver(
                self.A if A is None else A,
                self.b if b is None else b,
                self.psd_maps,
                self.epsilon_safemargin,
                len(self.free_params),
                device=self.idf.model.device,
            )
        self._last_solver = self._solver_cache[key]
        return self._solver_cache[key]

    # ------------------------------------------------------------------
    def _x0_free(self):
        m = self.idf.model
        return np.array([m.xStdModel[p] for p in self.free_params])

    def _expand_solution(self, x_free: np.ndarray) -> np.ndarray:
        """free -> full identified-param-space solution (with pins and
        deleted columns restored to a priori; reference sdp.py:618-621)."""
        m = self.idf.model
        x_id = self._scatter @ x_free + self._fixed_vec
        full = np.array(m.xStdModel[m.identified_params], dtype=float)
        # positions of idable within identified order
        idable_pos = [i for i, p in enumerate(m.identified_params) if p not in self.delete_cols]
        full[idable_pos] = x_id
        return full

    def checkFeasibility(self, prime: np.ndarray) -> bool:
        """Max violation of all constraints at a full-parameter vector
        (reference sdp.py:44-66)."""
        x_free = np.array([prime[p] for p in self.free_params])
        ok = True
        if self.A is not None:
            viol = self.A @ x_free - self.b
            if viol.max(initial=-np.inf) > 1e-6:
                ok = False
        for M in self.psd_maps:
            ev = np.linalg.eigvalsh(M(x_free))
            if ev[0] < self.epsilon_safemargin - 1e-9:
                ok = False
        return ok

    # ------------------------------------------------------------------
    def _observability_weights(self, R1_K: np.ndarray) -> np.ndarray:
        """Per-parameter CAD-pull weights from the ridge-inverted normal
        matrix (reference sdp.py:295-316), ordered like idable_params."""
        M = R1_K.T @ R1_K
        eps = 1e-6 * float(np.trace(M)) / M.shape[0]
        cov = np.clip(np.diag(la.inv(M + eps * np.eye(M.shape[0]))), 0.0, None)
        obs = np.sqrt(cov)
        pos = obs[obs > 0]
        med = float(np.median(pos)) if pos.size else 1.0
        return np.clip(obs / med, 0.1, 100.0)

    # ------------------------------------------------------------------
    def identifyFeasibleStandardParameters(self, idf) -> None:
        """Feasible std params minimizing the (projected) torque residual
        + CAD regularization (reference sdp.py:450-624)."""
        opt = idf.opt
        m = idf.model
        K = m.Binv if opt["useBasisProjection"] else m.K
        K = np.delete(K, self.delete_cols, axis=1)

        nb = m.num_base_params
        if m.YBase is None:
            # streaming mode: R1 from the Cholesky of the base Gram
            # (Y = Q R  =>  Y^T Y = R^T R, so chol(G)^T is a valid R),
            # rho1 = Q^T tau = R^{-T} Y^T tau = R^{-T} g_base.
            # f32-accumulated Grams can carry O(1e-7*trace) negative
            # eigenvalues — grow the ridge until the factorization holds
            lam = 1e-12 * max(float(np.trace(m.G_base)) / nb, 1.0)
            for _ in range(20):
                try:
                    R1 = sla.cholesky(m.G_base + lam * np.eye(nb), lower=False)
                    break
                except la.LinAlgError:
                    lam *= 100.0
            else:
                raise la.LinAlgError("base Gram not factorizable even with ridge")
            rho1 = sla.solve_triangular(R1.T, m.g_base, lower=True)
            contacts = sla.solve_triangular(R1.T, m.g_cf_base, lower=True)
        else:
            Q, R = la.qr(m.YBase)
            R1 = R[:nb, :nb]
            rho1 = Q[:, :nb].T @ m.torques_stack
            contacts = Q[:, :nb].T @ m.contactForcesSum
        R1_K = R1 @ K  # (nb, n_idable)
        if m.YBase is None and opt["useAPriori"]:
            # streaming Grams accumulate g_base against tau = torques -
            # tau_apriori (param-ERROR space) while the constraints and
            # CAD regularization below live in ABSOLUTE parameter space
            # (the materialized branch uses raw torques_stack). Fold the
            # a-priori contraction back: tau_ap = Y_id x_ap = Y_base K
            # x_ap_idable, so rho1_abs = rho1 + R1 K x_ap (deleted K
            # columns are zero-regressor params, so restricting to idable
            # columns is exact).
            x_ap_idable = np.asarray([m.xStdModel[p] for p in self.idable_params])
            rho1 = rho1 + R1_K @ x_ap_idable

        # residual rows + CAD regularization rows
        base_error = float(getattr(idf, "base_error", 1.0) or 1.0)
        reg_mode = opt.get("cadRegularizationMode", "uniform")
        rows = [R1_K]
        targets = [rho1 - contacts]
        if opt["useRegressorRegularization"]:
            if reg_mode == "observability":
                obs_w = self._observability_weights(R1_K)
                basew = base_error / len(self.idable_params) * float(opt["regularizationFactor"])
                Wrow = np.diag(basew * obs_w)
                rows.append(Wrow)
                targets.append(Wrow @ np.asarray([m.xStdModel[p] for p in self.idable_params]))
            elif reg_mode == "geometric":
                raise NotImplementedError(
                    "cadRegularizationMode='geometric' (the log-det SDP) is not "
                    "ported to flobaroid_tpu_torch yet (ROADMAP.md, queue 1)")
            else:
                p_nid = sorted(
                    set(m.non_id).difference(self.delete_cols).intersection(m.identified_params)
                )
                if p_nid:
                    basew = base_error / len(p_nid) * float(opt["regularizationFactor"])
                    Wrow = np.zeros((len(p_nid), len(self.idable_params)))
                    tgt = np.zeros(len(p_nid))
                    for i, p in enumerate(p_nid):
                        Wrow[i, self.pos_in_idable[p]] = basew
                        tgt[i] = basew * m.xStdModel[p]
                    rows.append(Wrow)
                    targets.append(tgt)

        lam_f = float(opt.get("frictionRegularization", 0))
        if lam_f > 0 and opt["identifyFrictionSimultaneously"]:
            # friction columns live at full-parameter indices >=
            # num_model_params (friction_params_start is an
            # IDENTIFIED-space offset and shrinks in gravity-only mode,
            # where it would wrongly match inertial params here)
            fidx = [p for p in self.idable_params if p >= m.num_model_params]
            if fidx:
                l_f = lam_f * np.sqrt(base_error / max(len(fidx), 1))
                Wrow = np.zeros((len(fidx), len(self.idable_params)))
                tgt = np.zeros(len(fidx))
                for i, p in enumerate(fidx):
                    Wrow[i, self.pos_in_idable[p]] = l_f
                    tgt[i] = l_f * m.xStdModel[p]
                rows.append(Wrow)
                targets.append(tgt)

        C = np.vstack(rows)
        d = np.concatenate(targets)
        # fold the fixed (pinned) contribution: C (scatter x + fixed) - d
        C_free = C @ self._scatter
        d_eff = d - C @ self._fixed_vec

        if opt.get("checkAPrioriFeasibility"):
            ok = self.checkFeasibility(m.xStdModel)
            print(f"a-priori parameters are "
                  f"{'feasible' if ok else 'INFEASIBLE'} for the "
                  f"consistency constraints")
        x, status = self._get_solver().solve_quadratic(
            self._x0_free(), 2.0 * C_free.T @ C_free, -2.0 * C_free.T @ d_eff,
            float(d_eff @ d_eff)
        )
        self.last_status = status
        self.last_info = self._solver_info()
        if status.startswith("optimal"):
            resid = float(np.linalg.norm(C_free @ x - d_eff) ** 2)
            if opt["verbose"]:
                print(f"SDP found std solution with {resid:.2f} squared residual error")
            m.xStd = self._expand_solution(x)
        else:
            print(f"SDP solver failed ({status}), keeping a priori parameters")
            m.xStd = np.array(m.xStdModel[m.identified_params], dtype=float)

    def identifyFeasibleStandardParametersDirect(self, idf) -> None:
        """Direct-YStd variant (reference sdp.py:626-699): quadratic
        objective from the device-accumulated Gram of the std regressor."""
        opt = idf.opt
        m = idf.model
        if m.YStd is None:
            # streaming: the same quadratic from the accumulated Grams
            # (Y^T(torques - cf) = g_tau - g_cf when no a-priori offset
            # is folded into tau)
            if opt["useAPriori"]:
                raise ValueError(
                    "materializeRegressor=0 + estimateWith=std_direct + "
                    "constrainToConsistent needs useAPriori=0 (the Grams "
                    "accumulate Y^T(tau - tau_apriori))"
                )
            G = np.delete(np.delete(m.G_std, self.delete_cols, 0),
                          self.delete_cols, 1)
            g = np.delete(m.g_tau - m.g_cf, self.delete_cols)
            tau_sq = float(m.tau_sq - 2.0 * m.tau_cf + m.cf_sq)
        else:
            Y = np.delete(m.YStd, self.delete_cols, axis=1)
            tau = m.torques_stack - m.contactForcesSum
            G = Y.T @ Y
            g = Y.T @ tau
            tau_sq = float(tau @ tau)
        base_error = float(getattr(idf, "base_error", 1.0) or 1.0)
        p_nid = sorted(set(m.non_id).difference(self.delete_cols).intersection(m.identified_params))
        if opt["useRegressorRegularization"] and p_nid:
            w = base_error / len(p_nid) * 1.5
            for p in p_nid:
                i = self.pos_in_idable[p]
                G[i, i] += w * w
                g[i] += w * w * m.xStdModel[p]
        S = self._scatter
        G_free = S.T @ G @ S
        g_free = S.T @ (g - G @ self._fixed_vec)

        x, status = self._get_solver().solve_quadratic(
            self._x0_free(), 2.0 * G_free, -2.0 * g_free, tau_sq
        )
        self.last_status = status
        self.last_info = self._solver_info()
        if status.startswith("optimal"):
            m.xStd = self._expand_solution(x)
        else:
            print(f"SDP solver failed ({status}), keeping a priori parameters")
            m.xStd = np.array(m.xStdModel[m.identified_params], dtype=float)

    def identifyFeasibleBaseParameters(self, idf) -> None:
        """Feasible base-parameter estimation. Like the reference
        (sdp.py:701-706), this variant is not implemented — base
        parameters have no direct physical-consistency cone; use
        identifyFeasibleStandardParameters and project."""
        print("identifyFeasibleBaseParameters is not implemented; use "
              "identifyFeasibleStandardParameters (std cone) instead")

    def findFeasibleStdFromFeasibleBase(self, idf, xBase: np.ndarray) -> None:
        """Closest-to-CAD std params consistent with given base params
        (reference sdp.py:708-770): min ||xStdModel - x||^2 s.t.
        K x = xBase +- tol plus all consistency constraints."""
        opt = idf.opt
        m = idf.model
        K = m.Binv if opt["useBasisProjection"] else m.K
        K = np.delete(K, self.delete_cols, axis=1)
        tol = float(opt.get("sdpBaseParamTol", 1e-3))

        K_free = K @ self._scatter
        k_off = K @ self._fixed_vec
        A_extra = np.vstack([K_free, -K_free])
        b_extra = np.concatenate([xBase + tol - k_off, -(xBase - tol) + k_off])
        A = np.vstack([self.A, A_extra]) if self.A is not None else A_extra
        b = np.concatenate([self.b, b_extra]) if self.b is not None else b_extra

        target = np.array([m.xStdModel[p] for p in self.free_params])
        nf = len(self.free_params)
        x, status = self._get_solver(A, b).solve_quadratic(
            self._x0_free(), 2.0 * np.eye(nf), -2.0 * target, float(target @ target)
        )
        self.last_status = status
        self.last_info = self._solver_info()
        if status.startswith("optimal"):
            if opt["verbose"]:
                dist = float(np.linalg.norm(x - target) ** 2)
                print(f"SDP found std solution with distance {dist:.2f} from CAD")
            m.xStd = self._expand_solution(x)
        else:
            print(f"Could not find closer-to-CAD solution ({status}), keeping previous")

    def findFeasibleStdFromStd(self, idf, xStd: np.ndarray) -> np.ndarray:
        """Project a std vector onto the feasible set
        (reference sdp.py:772-800)."""
        target = np.array([xStd[self._identified_pos(p)] for p in self.free_params])
        nf = len(self.free_params)
        x, status = self._get_solver().solve_quadratic(
            self._x0_free(), 2.0 * np.eye(nf), -2.0 * target, float(target @ target)
        )
        self.last_status = status
        self.last_info = self._solver_info()
        if status.startswith("optimal"):
            return self._expand_solution(x)
        return xStd

    def _identified_pos(self, p: int) -> int:
        m = self.idf.model
        return m.identified_params.index(p)
