"""Model: parameter bookkeeping, streamed Gram accumulation, QR base
projection — the fixed-base slice of flobaroid_tpu/model.py on torch.

What differs from the JAX module:
  * the per-dataset state is put on the model's device once per
    `computeRegressors` as plain tensors; every device pass (a-priori
    simulation, Grams, residual statistics, reporting contractions) is a
    Python loop over `gramChunk`-sample chunks that rebuilds the
    regressor chunk (no padding, no masks, no cached regressor stack);
  * both Gram sites — the per-channel Grams of the streamed identify and
    the structural Gram of `_random_gram` — go through the hand-written
    Gram kernel (`ops.gram.gram_batched`), each chunk's Gram in f32 and
    the sum over chunks in f64 on the device;
  * the structural states are drawn from a `torch.Generator` seeded 0 on
    the model's device, so the structural Gram differs in value from the
    JAX package's (its rank and column space do not).
Floating base, contacts and the fused walking path are not ported yet
(ROADMAP.md, queue 1) and raise NotImplementedError.

Parameter layout (reference model.py:131-208): 10 inertial params per
link [m, m*c, Ixx, Ixy, Ixz, Iyy, Iyz, Izz] about the link frame, then
optional friction blocks [Fc(n)] [Fv(n) | Fv+(n) Fv-(n)] [off(n)] [Fs(n)].
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg as sla
import torch

from flobaroid_tpu.models.urdf import RobotTree, joint_names_from_regressor_xml, load_urdf
from flobaroid_tpu.utils import helpers

from .data import Data
from .device import resolve_device, torch_dtype
from .dynamics.engine import DynamicsEngine
from .ops.gram import gram_batched


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flobaroid_tpu_torch yet (ROADMAP.md, queue 1)")


def _stribeck_series(vsig, vs):
    """Stribeck regressor term exp(-|v|/vs)*sign(v); shared by the
    regressor column and the simulated friction torque."""
    return np.exp(-np.abs(vsig) / vs) * np.sign(vsig)


class Model:
    def __init__(
        self,
        opt: dict[str, Any],
        urdf_file: str,
        regressor_file: str | None = None,
        regressor_init: bool = True,
        *,
        device,
    ):
        self.device = resolve_device(device)
        if opt["floatingBase"]:
            raise not_ported("floating-base identification")
        self.opt = opt
        self.urdf_file = urdf_file

        joint_order = None
        if regressor_file:
            joint_order = joint_names_from_regressor_xml(regressor_file)
        self.tree: RobotTree = load_urdf(urdf_file, joint_order=joint_order)
        self.engine = DynamicsEngine(self.tree)

        self.jointNames = list(self.tree.dof_names)
        self.num_dofs = self.tree.num_dofs
        self.num_links = self.tree.num_links
        self.linkNames = list(self.tree.link_names)
        self.limits = self.tree.joint_limits(use_deg=False)
        opt.setdefault("num_dofs", self.num_dofs)

        self.fb = 0

        # parameter bookkeeping (reference model.py:131-208)
        self.num_model_params = self.num_links * 10
        self.num_all_params = self.num_model_params
        self.inertia_params: list[int] = []
        for i in range(self.num_links):
            self.inertia_params.extend(range(i * 10 + 4, i * 10 + 10))

        nd = self.num_dofs
        self.num_identified_params = self.num_model_params
        if opt["identifyFrictionSimultaneously"]:
            self.num_identified_params += nd  # Fc
            self.num_all_params += nd
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    self.num_identified_params += nd  # Fv
                    self.num_all_params += nd
                else:
                    self.num_identified_params += 2 * nd  # Fv+, Fv-
                    self.num_all_params += 2 * nd
                self.num_identified_params += nd  # tau_off
                self.num_all_params += nd
                if opt.get("stribeckVelocity", 0) > 0:
                    self.num_identified_params += nd  # Fs
                    self.num_all_params += nd
        self.friction_params_start = self.num_model_params
        if opt["identifyGravityParamsOnly"]:
            self.num_identified_params -= len(self.inertia_params)
            self.friction_params_start = self.num_model_params - len(self.inertia_params)

        # a-priori standard params from URDF (+ friction from <dynamics>)
        self.xStdModel = np.concatenate(
            [self.tree.std_params(), np.zeros(self.num_all_params - self.num_model_params)]
        )
        if opt["identifyFrictionSimultaneously"]:
            self._add_friction_from_urdf(self.xStdModel)

        # indices (into the full param vector) of the identified columns
        self.identified_params: list[int] = []
        for i in range(self.num_links):
            self.identified_params.append(i * 10)  # mass
            self.identified_params.extend([i * 10 + 1, i * 10 + 2, i * 10 + 3])
            if not opt["identifyGravityParamsOnly"]:
                self.identified_params.extend(range(i * 10 + 4, i * 10 + 10))
        self.identified_params.extend(range(self.num_model_params, self.num_all_params))

        # state filled by computeRegressors / projections
        self.YStd: np.ndarray | None = None
        self.YBase: np.ndarray | None = None
        self.tau: np.ndarray | None = None
        self.torques_stack: np.ndarray | None = None
        self.torquesAP_stack: np.ndarray | None = None
        self.tauMeasured: np.ndarray | None = None
        self.contactForcesSum: np.ndarray | None = None
        self.T: np.ndarray | None = None
        self.xBase = np.array([])
        self.xBaseModel = np.array([])
        self.xStd = np.array([])
        if opt["estimateWith"] == "urdf":
            self.xStd = self.xStdModel.copy()
        self._staged: dict | None = None
        self._dataset_gen = 0
        # precision of the stored Grams (drives the QR rank threshold):
        # f64 exactly when the compute dtype is f64
        self._gram_dtype = (
            np.float64 if self._compute_dtype() == torch.float64 else np.float32)

        if regressor_init:
            self.computeRegressorLinDepsQR()

    # ------------------------------------------------------------------
    def _add_friction_from_urdf(self, params: np.ndarray, tree: RobotTree | None = None):
        """Fill Fc/Fv slots from the URDF <dynamics> friction/damping
        (reference: helpers.addFrictionFromURDF, helpers.py:438-480)."""
        tree = tree or self.tree
        nd = self.num_dofs
        start = self.num_model_params
        for i, jname in enumerate(self.jointNames):
            j = tree.joints[tree.dof_joint_ids[tree.dof_names.index(jname)]]
            params[start + i] = j.friction
            if not self.opt["identifyGravityParamsOnly"]:
                params[start + nd + i] = j.damping
                if not self.opt["identifySymmetricVelFriction"]:
                    params[start + 2 * nd + i] = j.damping
        if self.opt.get("stribeckVelocity", 0) > 0 and not self.opt["identifyGravityParamsOnly"]:
            fs_start = self.num_all_params - nd
            for i in range(nd):
                fc = params[start + i]
                params[fs_start + i] = abs(fc) * 0.6 if abs(fc) > 0 else 0.0

    def load_state(self, d: dict) -> None:
        """Install a-priori parameters and the structural base projection
        carried over from another model (see convert.py), so both compute
        with an identical projection."""
        self.xStdModel = np.array(d["xStdModel"], dtype=float)
        self.identified_params = [int(p) for p in d["identified_params"]]
        self.Q, self.R, self.P = (np.array(d[k]) for k in ("Q", "RQ", "PQ"))
        self._structural_gram_dtype = (
            np.float64 if "64" in str(d["gdt"]) else np.float32)
        self._base_projection(self._structural_gram_dtype)
        for k in ("Pb", "Pd", "K", "B", "Binv"):
            if k in d:
                setattr(self, k, np.array(d[k], dtype=float))
        self.num_base_params = int(d["num_base_params"])
        self.num_base_inertial_params = self.num_base_params - self.num_dofs

    # ------------------------------------------------------------------
    # device computation
    # ------------------------------------------------------------------
    def _compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.opt.get("computeDtype", "float32"))

    def _to_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self._compute_dtype(),
                               device=self.device)

    def _gather_state(self, samples: dict, idx: np.ndarray):
        Q = np.asarray(samples["positions"])[idx, : self.num_dofs]
        V = np.asarray(samples["velocities"])[idx, : self.num_dofs]
        A = np.asarray(samples["accelerations"])[idx, : self.num_dofs]
        if self.opt["identifyGravityParamsOnly"]:
            V = np.zeros_like(V)
            A = np.zeros_like(A)
        return Q, V, A

    def _friction_columns(self, samples: dict, idx: np.ndarray, V: np.ndarray):
        """Per-sample friction regressor columns (N, rows, n_fric)
        (reference model.py:459-503); diagonal blocks in the joint rows."""
        opt = self.opt
        nd = self.num_dofs
        N = len(idx)
        sign = helpers.get_friction_sign_series(samples, opt)[idx, :nd]
        cols = [sign[:, None, :] * np.eye(nd)[None, :, :]]  # Fc
        if not opt["identifyGravityParamsOnly"]:
            if opt["identifySymmetricVelFriction"]:
                cols.append(V[:, None, :] * np.eye(nd)[None, :, :])
            else:
                vp = np.where(V > 0, V, 0.0)
                vm = np.where(V < 0, V, 0.0)
                cols.append(vp[:, None, :] * np.eye(nd)[None, :, :])
                cols.append(vm[:, None, :] * np.eye(nd)[None, :, :])
            cols.append(np.broadcast_to(np.eye(nd), (N, nd, nd)).copy())  # tau_off
            if opt.get("stribeckVelocity", 0) > 0:
                vs = float(opt["stribeckVelocity"])
                vsig = helpers.get_friction_sign_velocities(samples, opt)[idx, :nd]
                cols.append(_stribeck_series(vsig, vs)[:, None, :] * np.eye(nd)[None, :, :])
        return np.concatenate(cols, axis=2)  # (N, nd, n_fric)

    def friction_torques(self, samples: dict, idx: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Analytic friction torques for parameter vector x (full layout),
        shape (N, n_dofs) (reference model.py:299-330)."""
        opt = self.opt
        if not opt["identifyFrictionSimultaneously"]:
            return np.zeros((len(idx), self.num_dofs))
        nd = self.num_dofs
        V = np.asarray(samples["velocities"])[idx, :nd]
        sign = helpers.get_friction_sign_series(samples, opt)[idx, :nd]
        start = self.num_model_params
        tau = sign * x[start : start + nd]
        if not opt["identifyGravityParamsOnly"]:
            if opt["identifySymmetricVelFriction"]:
                tau = tau + V * x[start + nd : start + 2 * nd]
                off = start + 2 * nd
            else:
                vp = np.where(V > 0, V, 0.0)
                vm = np.where(V < 0, V, 0.0)
                tau = tau + vp * x[start + nd : start + 2 * nd] + vm * x[start + 2 * nd : start + 3 * nd]
                off = start + 3 * nd
            tau = tau + x[off : off + nd]
            if opt.get("stribeckVelocity", 0) > 0:
                vs = float(opt["stribeckVelocity"])
                vsig = helpers.get_friction_sign_velocities(samples, opt)[idx, :nd]
                fs = x[self.num_all_params - nd : self.num_all_params]
                tau = tau + fs * _stribeck_series(vsig, vs)
        return tau

    def simulate_dynamics(self, samples: dict, idx: np.ndarray, x: np.ndarray | None = None):
        """Inverse-dynamics rows (N, rows) for parameter vector x
        (default: a-priori URDF params), friction included."""
        x = self.xStdModel if x is None else x
        if len(idx) == 0:
            return np.zeros((0, self.num_dofs))
        Q, V, A = self._gather_state(samples, idx)
        chunk = int(self.opt.get("gramChunk", 4096))
        pi = self._to_dev(x[: self.num_model_params])
        parts = []
        for s0 in range(0, len(idx), chunk):
            sl = slice(s0, s0 + chunk)
            _, sim_c = self._batched_rows(Q[sl], V[sl], A[sl], pi=pi, sim_only=True)
            parts.append(sim_c)
        sim = torch.cat(parts).double().cpu().numpy()
        sim += self.friction_torques(samples, idx, x)
        return sim

    def _batched_rows(self, Q, V, A, pi=None, sim_only=False):
        """Inertial regressor blocks (N, rows, 10L) and, when pi is given,
        simulated inverse-dynamics rows (N, rows), as device tensors."""
        Y = self.engine.regressor_batch(self._to_dev(Q), self._to_dev(V), self._to_dev(A))
        sim = None if pi is None else Y @ self._to_dev(pi)
        return (None if sim_only else Y), sim

    def computeRegressors(self, data: Data, only_simulate: bool = False) -> None:
        """Fills YStd (materialized mode) or the streamed Grams, plus tau,
        torques_stack, contactForcesSum, tauMeasured, T
        (reference model.py:333-632)."""
        opt = self.opt
        self.data = data
        self._contract_cache = {}  # contractions are per-dataset
        self._resid_cache = {}  # residual stats are per-dataset
        self._agg_cache = {}  # Gram aggregates are per-dataset
        self._staged = None  # staged device inputs are per-dataset
        self._dataset_gen += 1
        nd = self.num_dofs
        rows = nd
        skip = int(opt["skipSamples"])
        N = data.num_used_samples
        idx = np.arange(N) * (skip + 1)
        samples = data.samples
        if "contacts" in samples and np.asarray(samples["contacts"]).ndim == 0:
            raise not_ported("contact-wrench identification")

        Q, V, A = self._gather_state(samples, idx)
        need_sim = opt["simulateTorques"] or opt["useAPriori"]
        pi_urdf = self.xStdModel[: self.num_model_params]
        streaming = not int(opt.get("materializeRegressor", 1)) and not only_simulate
        Yin = sim = None
        if streaming:
            # simulate through the staged chunks (Y_id @ x_id equals
            # Yin @ pi + friction: identified columns only drop inertia
            # columns in gravity-only mode, where V = A = 0 zeroes them)
            staged = self._stage_streaming(samples, idx, Q, V, A)
            if need_sim:
                x_id = self.xStdModel[self.identified_params]
                sim = np.nan_to_num(self._scan_contract(staged, [x_id])[0])
        else:
            Yin, sim = self._batched_rows(
                Q, V, A, pi=pi_urdf if need_sim else None, sim_only=only_simulate)
            if Yin is not None:
                Yin = Yin.double().cpu().numpy()  # (N, rows, 10L)
            if sim is not None:
                sim = sim.double().cpu().numpy()
                sim += self.friction_torques(samples, idx, self.xStdModel)
                sim = np.nan_to_num(sim)

        # measured torques (a previous pass may have written back a
        # subsampled (N_used, rows) array — use it directly)
        tq_arr = np.asarray(samples["torques"])
        torq = np.array(tq_arr if tq_arr.shape[0] == N else tq_arr[idx])
        if opt["simulateTorques"]:
            torq = sim.copy()
        self.contactForcesSum = np.zeros(N * rows)

        self.torques_stack = torq.reshape(-1)
        self.torquesAP_stack = (sim.reshape(-1) if (sim is not None and opt["useAPriori"])
                                else np.zeros_like(self.torques_stack))
        if opt["simulateTorques"]:
            # write back into a COPY of the samples dict when it still
            # aliases data.measurements (later passes must not see the
            # subsampled array as the measurement)
            if data.samples is data.measurements:
                data.samples = dict(data.measurements)
            data.samples["torques"] = torq

        self.tau = (self.torques_stack - self.torquesAP_stack
                    if opt["useAPriori"] else self.torques_stack)
        self.tauMeasured = torq.reshape(N, rows)
        self.T = np.asarray(samples["times"])[idx]

        if only_simulate:
            return
        if streaming:
            self._compute_streaming(N, rows)
            return

        # assemble identified columns: inertial subset + friction columns
        Yfull = Yin
        if opt["identifyGravityParamsOnly"]:
            keep = [p for p in range(self.num_model_params) if p not in set(self.inertia_params)]
            Yfull = Yin[:, :, keep]
        if opt["identifyFrictionSimultaneously"]:
            Vf = V if not opt["identifyGravityParamsOnly"] else np.asarray(samples["velocities"])[idx, :nd]
            Yfull = np.concatenate([Yfull, self._friction_columns(samples, idx, Vf)], axis=2)
        self.YStd = Yfull.reshape(N * rows, self.num_identified_params)

        # when not trusting the structural regressor, re-derive the base
        # projection from the data regressor (reference model.py:598-601)
        if not opt["useStructuralRegressor"]:
            self.computeRegressorLinDepsQR(self.YStd)
        self.YBase = self.YStd @ (self.B if opt["useBasisProjection"] else self.Pb)

        if opt["filterRegressor"]:
            import scipy.signal as sig

            fs = float(samples["frequency"])
            b, a = sig.butter(5, float(opt["filterRegCutoff"]) / (fs / 2), btype="low")
            for j in range(self.num_base_inertial_params):
                for i in range(rows):
                    self.YBase[i::rows, j] = sig.filtfilt(b, a, self.YBase[i::rows, j])

    # ------------------------------------------------------------------
    # streaming Gram accumulation (materializeRegressor=0)
    # ------------------------------------------------------------------
    def _identified_columns(self, Y, V, sign, vsig):
        """Identified-column assembly on the device: inertial subset +
        friction blocks (mirrors the host path)."""
        opt = self.opt
        nd = self.num_dofs
        if opt["identifyGravityParamsOnly"]:
            keep = torch.tensor([p for p in range(self.num_model_params) if p % 10 < 4],
                                device=Y.device)
            Y = Y[:, :, keep]
        if opt["identifyFrictionSimultaneously"]:
            blocks = [torch.diag_embed(sign)]
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    blocks.append(torch.diag_embed(V))
                else:
                    blocks.append(torch.diag_embed(torch.clamp(V, min=0.0)))
                    blocks.append(torch.diag_embed(torch.clamp(V, max=0.0)))
                eye = torch.eye(nd, dtype=Y.dtype, device=Y.device)
                blocks.append(eye.expand(Y.shape[0], nd, nd))
                if opt.get("stribeckVelocity", 0) > 0:
                    vs = float(opt["stribeckVelocity"])
                    blocks.append(torch.diag_embed(torch.exp(-vsig.abs() / vs) * torch.sign(vsig)))
            Y = torch.cat([Y, *blocks], dim=2)
        return Y

    def _stage_streaming(self, samples, idx, Q, V, A) -> dict:
        """Put the per-sample state on the device once per dataset; the
        simulation pass, the Gram pass and every reporting contraction
        read it from there. Invalidated at the top of computeRegressors."""
        st = self._staged
        if st is not None and st["N"] == len(idx):
            return st
        vsig = helpers.get_friction_sign_velocities(samples, self.opt)[idx, : self.num_dofs]
        st = dict(N=len(idx), chunk=int(self.opt.get("gramChunk", 4096)),
                  Q=self._to_dev(Q), V=self._to_dev(V), A=self._to_dev(A),
                  vsig=self._to_dev(vsig))
        self._staged = st
        return st

    def _identified_chunks(self, st):
        """(slice, identified regressor chunk (n, rows, P)) over the staged
        dataset. The Coulomb sign series is derived on the device from the
        sign velocities (the tanh of helpers.get_friction_sign_series)."""
        thresh = float(self.opt.get("frictionSignThreshold", 0.02))
        for s0 in range(0, st["N"], st["chunk"]):
            sl = slice(s0, s0 + st["chunk"])
            V, vsig = st["V"][sl], st["vsig"][sl]
            Y = self.engine.regressor_batch(st["Q"][sl], V, st["A"][sl])
            yield sl, self._identified_columns(Y, V, torch.tanh(vsig / thresh), vsig)

    def _scan_contract(self, staged, xs) -> np.ndarray:
        """(K, N, rows) torque contractions tau_hat = Y @ x_k over the
        staged chunks."""
        xj = self._to_dev(np.stack(xs))
        outs = [torch.einsum("nrp,kp->knr", Y, xj)
                for _, Y in self._identified_chunks(staged)]
        return torch.cat(outs, dim=1).double().cpu().numpy()

    def _compute_streaming(self, N, rows):
        opt = self.opt
        if opt["filterRegressor"]:
            raise ValueError(
                "materializeRegressor=0 cannot filter regressor columns "
                "(filterRegressor needs the stacked regressor)")
        st = self._staged
        P = self.num_identified_params
        tau2d = self.tau.reshape(N, rows)
        cf2d = self.contactForcesSum.reshape(N, rows)
        tau = self._to_dev(tau2d)
        cf = self._to_dev(cf2d)
        # per-output-channel Grams in ONE kernel launch per chunk: tau and
        # the contact column appended to the regressor, so the channel's
        # G = Y^T Y, g = Y^T tau and gcf = Y^T cf all come out of the
        # (P+2, P+2) augmented Gram; summed over chunks in f64
        Gaug = torch.zeros((rows, P + 2, P + 2), dtype=torch.float64, device=self.device)
        for sl, Y in self._identified_chunks(st):
            aug = torch.cat([Y, tau[sl, :, None], cf[sl, :, None]], dim=2)
            Gaug += gram_batched(aug).double()

        self.YStd = None
        self.YBase = None
        self.G_rows = Gaug[:, :P, :P]
        self.g_rows = Gaug[:, :P, P]
        self.gcf_rows = Gaug[:, :P, P + 1]
        self.tau_sq_rows = (tau2d**2).sum(axis=0)
        self.tau_cf_rows = (tau2d * cf2d).sum(axis=0)
        self.cf_sq_rows = (cf2d**2).sum(axis=0)
        self._set_streaming_aggregates(np.ones(rows))

        if not opt["useStructuralRegressor"]:
            # the Gram shares the regressor's column dependencies
            self.computeRegressorLinDepsQR(self.G_std)
            self._set_streaming_aggregates(np.ones(rows))

    def _set_streaming_aggregates(self, w2) -> None:
        """Aggregate the per-channel Grams with channel weights² `w2`
        (w2=1: plain OLS; WLS rescales channel r by w_r, i.e. its Gram
        by w_r²). Contracted on the device; only the (P,P)/(P,)
        aggregates come to the host. Memoized per weight vector."""
        opt = self.opt
        w2 = np.asarray(w2, dtype=float)
        key = w2.tobytes()
        cache = self._agg_cache
        if key in cache:
            (self.G_std, self.g_tau, self.g_cf, self.tau_sq, self.tau_cf,
             self.cf_sq, self.G_base, self.g_base, self.g_cf_base) = cache[key]
            return
        w = torch.as_tensor(w2, dtype=torch.float64, device=self.device)
        self.G_std = torch.einsum("r,rpq->pq", w, self.G_rows).cpu().numpy()
        self.g_tau = (w @ self.g_rows).cpu().numpy()
        self.g_cf = (w @ self.gcf_rows).cpu().numpy()
        self.tau_sq = float(w2 @ self.tau_sq_rows)
        self.tau_cf = float(w2 @ self.tau_cf_rows)
        self.cf_sq = float(w2 @ self.cf_sq_rows)
        Pb = self.B if opt["useBasisProjection"] else self.Pb
        self.G_base = Pb.T @ self.G_std @ Pb
        self.g_base = Pb.T @ self.g_tau
        self.g_cf_base = Pb.T @ self.g_cf
        cache[key] = (self.G_std, self.g_tau, self.g_cf, self.tau_sq,
                      self.tau_cf, self.cf_sq, self.G_base, self.g_base,
                      self.g_cf_base)

    def contract_identified(self, x_identified) -> np.ndarray:
        """tau_hat = Y @ x recomputed on the device in chunks (streaming
        mode, where YStd is never materialized). Returns (N, rows).
        Cached per parameter vector until the next computeRegressors."""
        x = np.asarray(x_identified, dtype=float)
        key = x.tobytes()
        if key not in self._contract_cache:
            self._contract_cache[key] = self.contract_identified_multi([x])[0]
        return self._contract_cache[key]

    def residual_stats(self, xs):
        """Residual statistics for K parameter vectors against the
        measured torques (+ contact correction), computed on the device:
        list of dicts {rp (rows,), pp (rows,), tp (rows,), bn scalar} with
        rp[r] = ||tau_r - Y_r x - cf_r||², pp[r] = ||Y_r x + cf_r||²,
        tp[r] = ||tau_r||², bn = sum_n ||tau_n - tau_hat_n||. None when no
        dataset is staged. Cached per vector until the next
        computeRegressors."""
        st = self._staged
        if st is None or st["N"] != self.data.num_used_samples:
            return None
        xs = [np.asarray(x, dtype=float) for x in xs]
        cache = self._resid_cache
        missing = [x for x in xs if x.tobytes() not in cache]
        if missing:
            N, rows, K = st["N"], self.num_dofs, len(missing)
            taum = self._to_dev(self.tauMeasured)
            cf = self._to_dev(self.contactForcesSum.reshape(N, rows))
            xj = self._to_dev(np.stack(missing))
            f64 = dict(dtype=torch.float64, device=self.device)
            rp, pp = torch.zeros((K, rows), **f64), torch.zeros((K, rows), **f64)
            tp, bn = torch.zeros(rows, **f64), torch.zeros(K, **f64)
            for sl, Y in self._identified_chunks(st):
                pred = torch.einsum("nrp,kp->knr", Y, xj) + cf[sl][None]
                r = taum[sl][None] - pred
                r2 = r * r
                rp += r2.sum(dim=1).double()
                pp += (pred * pred).sum(dim=1).double()
                tp += (taum[sl] ** 2).sum(dim=0).double()
                bn += torch.sqrt(r2.sum(dim=2)).sum(dim=1).double()
            flat = torch.cat([rp.ravel(), pp.ravel(), tp, bn]).cpu().numpy()
            rp = flat[: K * rows].reshape(K, rows)
            pp = flat[K * rows : 2 * K * rows].reshape(K, rows)
            tp = flat[2 * K * rows : 2 * K * rows + rows]
            bn = flat[2 * K * rows + rows :]
            for i, x in enumerate(missing):
                cache[x.tobytes()] = dict(rp=rp[i], pp=pp[i], tp=tp, bn=float(bn[i]))
        return [cache[x.tobytes()] for x in xs]

    def prefetch_contractions(self, xs) -> None:
        """Several contractions in ONE pass over the data."""
        xs = [np.asarray(x, dtype=float) for x in xs]
        missing = [x for x in xs if x.tobytes() not in self._contract_cache]
        if not missing:
            return
        for x, r in zip(missing, self.contract_identified_multi(missing)):
            self._contract_cache[x.tobytes()] = r

    def contract_identified_multi(self, xs) -> np.ndarray:
        """(K, N, rows) torque contractions for K parameter vectors."""
        N = self.data.num_used_samples
        staged = self._staged
        if staged is None or staged["N"] != N:
            idx = np.arange(N) * (int(self.opt["skipSamples"]) + 1)
            Q, V, A = self._gather_state(self.data.samples, idx)
            staged = self._stage_streaming(self.data.samples, idx, Q, V, A)
        return self._scan_contract(staged, xs)

    # ------------------------------------------------------------------
    # structural (random) regressor + QR base projection
    # ------------------------------------------------------------------
    def getRandomRegressor(self, n_samples: int | None = None):
        """Structural Gram Y^T Y over random states within URDF limits,
        cached to <urdf>.regressor.npz with the JAX package's key layout
        (R, Q, RQ, PQ, n, fb, grav_only, fric, fric_sym, gdt)."""
        opt = self.opt
        suffix = ".gravity_regressor.npz" if opt["identifyGravityParamsOnly"] else ".regressor.npz"
        regr_filename = self.urdf_file + suffix
        fb = 0
        if not n_samples:
            n_samples = self.num_dofs * 1000

        def _matches(f) -> bool:
            return (
                int(f["n"]) == n_samples
                and int(f["fb"]) == fb
                and f["R"].shape[0] == self.num_identified_params
                and bool(f["grav_only"]) == bool(opt["identifyGravityParamsOnly"])
                and bool(f["fric"]) == bool(opt["identifyFrictionSimultaneously"])
                and bool(f["fric_sym"]) == bool(opt["identifySymmetricVelFriction"])
            )

        # the canonical file keeps the reference npz layout; other options
        # go to an options-keyed sidecar so the canonical cache is never
        # clobbered
        sidecar = "%s.n%d_fb%d_g%d_f%d_s%d%s" % (
            self.urdf_file,
            n_samples,
            fb,
            int(bool(opt["identifyGravityParamsOnly"])),
            int(bool(opt["identifyFrictionSimultaneously"])),
            int(bool(opt["identifySymmetricVelFriction"])),
            suffix,
        )
        canonical_taken = False
        for path in (regr_filename, sidecar):
            try:
                f = np.load(path)
                if _matches(f):
                    # the rank threshold follows the precision of the Gram
                    # AS STORED (caches without a stamp are assumed f32)
                    gdt = str(f["gdt"]) if "gdt" in f.files else "float32"
                    self._structural_gram_dtype = np.float64 if "64" in gdt else np.float32
                    return f["R"], f["Q"], f["RQ"], f["PQ"]
                if path == regr_filename:
                    canonical_taken = True
            except (OSError, KeyError, ValueError):
                pass

        R = self._random_gram(n_samples)
        self._structural_gram_dtype = self._gram_dtype
        Q, RQ, PQ = sla.qr(R, pivoting=True, mode="economic")
        try:
            np.savez(
                sidecar if canonical_taken else regr_filename,
                R=R, Q=Q, RQ=RQ, PQ=PQ, n=n_samples, fb=fb,
                grav_only=opt["identifyGravityParamsOnly"],
                fric=opt["identifyFrictionSimultaneously"],
                fric_sym=opt["identifySymmetricVelFriction"],
                gdt=np.dtype(self._gram_dtype).name,
            )
        except OSError:
            pass  # read-only model dir: recompute next time
        return R, Q, RQ, PQ

    def _random_gram(self, n_samples: int) -> np.ndarray:
        """Structural Gram over `n_samples` random in-limit states, drawn
        from a torch.Generator seeded 0 on the model's device, in chunks
        of `gramChunk` samples; each chunk's Gram (n*nd rows x P) is one
        B=1 launch of the Gram kernel, summed over chunks in f64."""
        opt = self.opt
        nd = self.num_dofs
        dt = self._compute_dtype()
        grav_only = bool(opt["identifyGravityParamsOnly"])
        fric = bool(opt["identifyFrictionSimultaneously"])

        jn = self.jointNames
        if self.limits:
            lo = np.array([self.limits[j]["lower"] for j in jn])
            hi = np.array([self.limits[j]["upper"] for j in jn])
            vl = np.array([self.limits[j]["velocity"] for j in jn])
            lo = np.where(np.isfinite(lo), lo, -np.pi)
            hi = np.where(np.isfinite(hi), hi, np.pi)
            vl = np.where(np.isfinite(vl), vl, np.pi)
        else:
            lo, hi, vl = -np.pi * np.ones(nd), np.pi * np.ones(nd), np.pi * np.ones(nd)
        lo, span, vl = self._to_dev(lo), self._to_dev(hi - lo), self._to_dev(vl)

        sign_thresh = float(opt.get("frictionSignThreshold", 0.02))
        stribeck = float(opt.get("stribeckVelocity", 0) or 0)
        sym = bool(opt["identifySymmetricVelFriction"])
        keep = None
        if grav_only:
            keep = torch.tensor([p for p in range(self.num_model_params)
                                 if p not in set(self.inertia_params)], device=self.device)

        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        chunk = int(opt.get("gramChunk", 4096))
        P = self.num_identified_params
        G = torch.zeros((1, P, P), dtype=torch.float64, device=self.device)
        for s0 in range(0, n_samples, chunk):
            c = min(chunk, n_samples - s0)
            u = torch.rand((3, c, nd), generator=gen, dtype=dt, device=self.device)
            q = lo + span * u[0]
            if grav_only:
                dq = torch.zeros_like(q)
                ddq = torch.zeros_like(q)
            else:
                dq = (u[1] - 0.5) * 2 * vl
                ddq = (u[2] - 0.5) * 2 * np.pi
            Y = self.engine.regressor_batch(q, dq, ddq)  # (c, nd, 10L)
            if keep is not None:
                Y = Y[:, :, keep]
            if fric:
                blocks = [torch.diag_embed(torch.tanh(dq / sign_thresh))]
                if not grav_only:
                    if sym:
                        blocks.append(torch.diag_embed(dq))
                    else:
                        blocks.append(torch.diag_embed(torch.clamp(dq, min=0.0)))
                        blocks.append(torch.diag_embed(torch.clamp(dq, max=0.0)))
                    blocks.append(torch.eye(nd, dtype=dt, device=self.device).expand(c, nd, nd))
                    if stribeck > 0:
                        blocks.append(torch.diag_embed(
                            torch.exp(-dq.abs() / stribeck) * torch.sign(dq)))
                Y = torch.cat([Y, *blocks], dim=2)
            G += gram_batched(Y.reshape(c * nd, 1, P)).double()
        return G[0].cpu().numpy()

    def computeRegressorLinDepsQR(self, regressor: np.ndarray | None = None) -> None:
        """Pivoted-QR base-parameter projection (reference model.py:832-1052):
        rank via minTol on the R diagonal, permutation Pb/Pd, dependency
        matrix K = Pb^T + Kd Pd^T (Gautier/Sousa), optional orthonormal
        basis B, non-identifiable parameter set."""
        if regressor is not None:
            self.Q, self.R, self.P = sla.qr(regressor, pivoting=True, mode="economic")
            qr_gdt = self._gram_dtype
        else:
            _, self.Q, self.R, self.P = self.getRandomRegressor(
                n_samples=self.opt["randomSamples"])
            # a structural cache may be stamped with another dtype than
            # this model accumulates in: the threshold follows the Gram
            # as decomposed here
            qr_gdt = getattr(self, "_structural_gram_dtype", self._gram_dtype)
        self._base_projection(qr_gdt)

    def _base_projection(self, qr_gdt) -> None:
        """Everything computeRegressorLinDepsQR derives from the pivoted QR
        factors (self.Q, self.R, self.P) of a Gram of precision qr_gdt."""
        opt = self.opt
        # Pb/B/K change here — cached base-space Gram aggregates are stale
        self._agg_cache = {}
        # rank threshold: the absolute minTol, and relative to the
        # spectrum scale at the Gram's precision (an f32 Gram's noise
        # floor reads as spurious base directions under minTol alone)
        minTol = float(opt["minTol"])
        diag = np.abs(np.diag(self.R))
        eps = np.finfo(qr_gdt).eps
        tol = max(minTol, 100.0 * eps * float(diag.max(initial=0.0)))
        r = int(np.sum(diag > tol))
        self.num_base_params = r
        self.num_base_inertial_params = r - self.num_dofs

        P = self.P
        nP = P.size
        Pp = np.zeros((nP, nP))
        for i in P:
            Pp[i, P[i]] = 1
        self.Pp = Pp
        self.Pb = Pp.T[:, :r]
        self.Pd = Pp.T[:, r:]
        self.independent_cols = P[:r]

        R1 = self.R[:r, :r]
        R2 = self.R[:r, r:]
        self.linear_deps = sla.solve_triangular(R1, R2)
        self.linear_deps[np.abs(self.linear_deps) < minTol] = 0
        self.Kd = self.linear_deps
        self.K = self.Pb.T + self.Kd @ self.Pd.T

        if opt["useBasisProjection"]:
            B = np.zeros((self.num_identified_params, r))
            for j in range(self.linear_deps.shape[0]):
                for k in range(r, nP):
                    factor = self.linear_deps[j, k - r]
                    if abs(factor) > minTol:
                        B[P[k], j] = factor
                B[self.independent_cols[j], j] = 1
            if opt["orthogonalizeBasis"]:
                Qb, Rb = np.linalg.qr(B)
                Qb[np.abs(Qb) < minTol] = 0
                S = np.zeros_like(Rb)
                for i in range(Rb.shape[0]):
                    if abs(Rb[i, i]) >= minTol:
                        S[i, i] = np.sign(Rb[i, i])
                self.B = Qb @ S
                self.Binv = self.B.T
            else:
                self.B = B
                self.Binv = np.linalg.pinv(B)

        # non-identifiable params: no (significant) contribution to any
        # base combination. Index space: full param vector.
        contrib = np.any(np.abs(self.K) > minTol, axis=0)
        ident_mask = np.zeros(self.num_all_params, dtype=bool)
        for ci, p in enumerate(self.identified_params):
            if contrib[ci]:
                ident_mask[p] = True
        self.non_id = [p for p in range(self.num_all_params) if not ident_mask[p]]
        self.identifiable = [p for p in range(self.num_all_params) if ident_mask[p]]

    def getSubregressorsConditionNumbers(self, YBase=None, G=None) -> list[float]:
        """Per-link condition number of the base columns its parameters
        contribute to (reference model.py:1054-1086), from an explicit
        stacked regressor / base Gram, the materialized YBase, or the
        streamed base Gram."""
        minTol = float(self.opt["minTol"])
        if YBase is None and G is None:
            YBase = self.YBase
            if YBase is None:
                # streaming: cond2(Y[:, cols]) = sqrt(cond2(G[cols, cols]))
                G = getattr(self, "G_base", None)
                if G is None:
                    raise ValueError(
                        "subregressor condition numbers need computeRegressors "
                        "to have run (YBase or the streamed base Gram)")
        conds = []
        for i in range(self.num_links):
            cols = []
            for k in range(i * 10, i * 10 + 10):
                try:
                    ci = self.identified_params.index(k)
                except ValueError:
                    continue
                for j in range(self.num_base_params):
                    if abs(self.K[j, ci]) > minTol and j not in cols:
                        cols.append(j)
            if not cols:
                conds.append(1e16)
            elif YBase is not None:
                conds.append(float(np.linalg.cond(YBase[:, cols])))
            else:
                ev = np.linalg.eigvalsh(np.asarray(G)[np.ix_(cols, cols)])
                conds.append(1e16 if ev[0] <= 0 else float(np.sqrt(ev[-1] / ev[0])))
        return conds
