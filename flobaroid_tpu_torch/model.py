"""Model: parameter bookkeeping, streamed Gram accumulation, QR base
projection — flobaroid_tpu/model.py on torch, fixed and floating base,
with contact wrenches.

What differs from the JAX module:
  * the per-dataset state is put on the model's device once per
    `computeRegressors` as plain tensors; every device pass (a-priori
    simulation, contact J^T w, Grams, residual statistics, reporting
    contractions) is a Python loop over `gramChunk`-sample chunks that
    rebuilds what it needs of the chunk (no padding, no masks, no cached
    regressor stack);
  * both Gram sites — the per-channel Grams of the streamed identify and
    the structural Gram of `_random_gram` — go through the hand-written
    Gram kernel (`ops.gram.gram_batched`), each chunk's Gram in f32 and
    the sum over chunks in f64 on the device;
  * the walking-contact pass computes the same numbers as the JAX
    package's fused walking scan (per-channel G/g/gcf, the tau/cf square
    sums, the a-priori residual statistics) as separate chunk loops: the
    contact J^T w first, folded into the measured base-wrench rows on the
    host in f64, then the Grams with tau and cf appended;
  * the structural states are drawn from a `torch.Generator` seeded 0 on
    the model's device, so the structural Gram differs in value from the
    JAX package's (its rank and column space do not);
  * `shardSamples: n > 1` splits each chunk's samples into n contiguous
    shard slices, shard i on device i of a `parallel.mesh.Mesh` (on one
    card, all shards on it), in one process; every pass reduces or
    concatenates the shards' results on the model's device in f64, in
    shard order. The structural Gram draws the same states as unsharded
    and splits each chunk's rows over the shards.

Parameter layout (reference model.py:131-208): 10 inertial params per
link [m, m*c, Ixx, Ixy, Ixz, Iyy, Iyz, Izz] about the link frame, then
optional friction blocks [Fc(n)] [Fv(n) | Fv+(n) Fv-(n)] [off(n)] [Fs(n)].
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg as sla
import torch

from .data import Data
from .device import resolve_device, torch_dtype
from .dynamics.engine import DynamicsEngine, rpy_to_base_rot, rpy_to_base_rot_np
from .models.urdf import RobotTree, joint_names_from_regressor_xml, load_urdf
from .ops.gram import cat_padded, gram_batched
from .parallel.mesh import Mesh, make_mesh, shard_slices
from .utils import helpers


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
        device="cuda",
    ):
        self.device = resolve_device(device)
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

        self.fb = 6 if opt["floatingBase"] else 0
        self.N_OUT = self.num_dofs + self.fb

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

        self.baseNames = ["base f_x", "base f_y", "base f_z", "base m_x", "base m_y", "base m_z"]

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

        # names per parameter of the full layout (for reports)
        self.param_names: list[str] = []
        comp = ["m", "cx", "cy", "cz", "Ixx", "Ixy", "Ixz", "Iyy", "Iyz", "Izz"]
        for i in range(self.num_links):
            for c in comp:
                self.param_names.append(f"{c}_{i}")
        for blk, cnt in self._friction_block_names():
            for i in range(cnt):
                self.param_names.append(f"{blk}_{i}")

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
        self._meshes: dict = {}
        # precision of the stored Grams (drives the QR rank threshold):
        # f64 exactly when the compute dtype is f64
        self._gram_dtype = (
            np.float64 if self._compute_dtype() == torch.float64 else np.float32)

        if regressor_init:
            self.computeRegressorLinDepsQR()

    def getDescriptionOfParameters(self) -> str:
        """Human-readable description of every standard parameter
        (reference model.py:210-237)."""
        names = [
            "mass", "first moment of mass (x)", "first moment of mass (y)",
            "first moment of mass (z)", "moment of inertia (xx)",
            "moment of inertia (xy)", "moment of inertia (xz)",
            "moment of inertia (yy)", "moment of inertia (yz)",
            "moment of inertia (zz)",
        ]
        out = []
        for i in range(self.num_links):
            for j, n in enumerate(names):
                out.append(f"Parameter {i * 10 + j}: {n} of link {self.linkNames[i]}")
        return "\n".join(out) + "\n"

    def _friction_block_names(self) -> list[tuple[str, int]]:
        """(name, count) of the friction blocks after the inertial
        parameters, in layout order."""
        opt = self.opt
        nd = self.num_dofs
        blocks = []
        if opt["identifyFrictionSimultaneously"]:
            blocks.append(("Fc", nd))
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    blocks.append(("Fv", nd))
                else:
                    blocks.append(("Fv+", nd))
                    blocks.append(("Fv-", nd))
                blocks.append(("off", nd))
                if opt.get("stribeckVelocity", 0) > 0:
                    blocks.append(("Fs", nd))
        return blocks

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
        with an identical projection. The other model must have the same
        base (fixed or floating): its projection is of another regressor
        otherwise."""
        if int(d["fb"]) != self.fb:
            raise ValueError(f"state of a model with fb={int(d['fb'])} loaded into one "
                             f"with fb={self.fb} (floatingBase differs)")
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

    def _to_dev(self, a, device=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self._compute_dtype(),
                               device=self.device if device is None else device)

    def _sample_mesh(self) -> Mesh:
        """The mesh of the `shardSamples` shards on the model's device
        type; one shard on the model's device when it is 0 or 1."""
        n = max(int(self.opt.get("shardSamples", 0) or 0), 1)
        if n not in self._meshes:
            self._meshes[n] = (make_mesh(n, device=self.device, axis="samples") if n > 1
                               else Mesh((self.device,), "samples"))
        return self._meshes[n]

    def _sample_pieces(self, N: int) -> list[tuple[slice, torch.device]]:
        """(slice, device) of every piece of N samples, in sample order:
        chunks of `gramChunk` samples (rounded up to a multiple of the
        shard count, as the JAX package does), each cut into the shard
        slices of `parallel.mesh.shard_slices`, shard i on mesh device i.
        A short tail leaves the last shards empty: no piece is made for
        them."""
        mesh = self._sample_mesh()
        chunk = -(-int(self.opt.get("gramChunk", 4096)) // mesh.size) * mesh.size
        pieces = []
        for s0 in range(0, N, chunk):
            c = min(chunk, N - s0)
            for sl, dev in zip(shard_slices(c, mesh.size), mesh.devices):
                pieces.append((slice(s0 + sl.start, s0 + sl.stop), dev))
        return pieces

    def _gather_state(self, samples: dict, idx: np.ndarray):
        """Host state (Q, V, A, BR, BV, BA) of the samples idx; the base
        series are None for a fixed base. BR is world_R_base from the
        stored `base_rpy`."""
        Q = np.asarray(samples["positions"])[idx, : self.num_dofs]
        V = np.asarray(samples["velocities"])[idx, : self.num_dofs]
        A = np.asarray(samples["accelerations"])[idx, : self.num_dofs]
        if self.opt["identifyGravityParamsOnly"]:
            V = np.zeros_like(V)
            A = np.zeros_like(A)
        BR = BV = BA = None
        if self.fb:
            BR = rpy_to_base_rot_np(np.asarray(samples["base_rpy"])[idx])
            BV = np.asarray(samples["base_velocity"])[idx]
            BA = np.asarray(samples["base_acceleration"])[idx]
            if self.opt["identifyGravityParamsOnly"]:
                # gravity-only is a statics assumption: no base motion
                # either, so the dropped inertia columns contribute nothing
                BV = np.zeros_like(BV)
                BA = np.zeros_like(BA)
        return Q, V, A, BR, BV, BA

    def _friction_columns(self, samples: dict, idx: np.ndarray, V: np.ndarray):
        """Per-sample friction regressor columns (N, rows, n_fric)
        (reference model.py:459-503); diagonal blocks in the joint rows,
        zero base-wrench rows."""
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
        F = np.concatenate(cols, axis=2)  # (N, nd, n_fric)
        return np.concatenate([np.zeros((N, self.fb, F.shape[2])), F], axis=1)

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
            return np.zeros((0, self.N_OUT))
        state = self._gather_state(samples, idx)
        pi = x[: self.num_model_params]
        parts = []
        for sl, dev in self._sample_pieces(len(idx)):
            chunk_state = [None if a is None else a[sl] for a in state]
            _, sim_c = self._batched_rows(*chunk_state, pi=pi, sim_only=True, device=dev)
            parts.append(sim_c.to(self.device))
        sim = torch.cat(parts).double().cpu().numpy()
        sim[:, self.fb:] += self.friction_torques(samples, idx, x)
        return sim

    def _batched_rows(self, Q, V, A, BR=None, BV=None, BA=None, pi=None, sim_only=False,
                      device=None):
        """Inertial regressor blocks (N, rows, 10L) and, when pi is given,
        simulated inverse-dynamics rows (N, rows), as tensors on `device`
        (default: the model's)."""
        base = [None if a is None else self._to_dev(a, device) for a in (BR, BV, BA)]
        Y = self.engine.regressor_batch(self._to_dev(Q, device), self._to_dev(V, device),
                                        self._to_dev(A, device), *base)
        sim = None if pi is None else Y @ self._to_dev(pi, device)
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
        nd, fb = self.num_dofs, self.fb
        rows = nd + fb
        skip = int(opt["skipSamples"])
        N = data.num_used_samples
        idx = np.arange(N) * (skip + 1)
        samples = data.samples

        Q, V, A, BR, BV, BA = self._gather_state(samples, idx)
        # the a-priori simulation is needed for simulated torques, for
        # useAPriori, and to fill the 6 base-wrench rows of a floating-base
        # dataset that carries joint torques only
        tq_cols = np.asarray(samples["torques"]).shape[-1]
        need_sim = opt["simulateTorques"] or opt["useAPriori"] or (fb and tq_cols < rows)
        pi_urdf = self.xStdModel[: self.num_model_params]
        streaming = not int(opt.get("materializeRegressor", 1)) and not only_simulate
        Yin = sim = None
        if streaming:
            # simulate through the staged chunks (Y_id @ x_id equals
            # Yin @ pi + friction: identified columns only drop inertia
            # columns in gravity-only mode, where V = A = 0 zeroes them)
            staged = self._stage_streaming(samples, idx, Q, V, A, BR, BV, BA)
            if need_sim:
                x_id = self.xStdModel[self.identified_params]
                sim = np.nan_to_num(self._scan_contract(staged, [x_id])[0])
        else:
            Yin, sim = self._batched_rows(
                Q, V, A, BR, BV, BA, pi=pi_urdf if need_sim else None, sim_only=only_simulate)
            if Yin is not None:
                Yin = Yin.double().cpu().numpy()  # (N, rows, 10L)
            if sim is not None:
                sim = sim.double().cpu().numpy()
                sim[:, fb:] += self.friction_torques(samples, idx, self.xStdModel)
                sim = np.nan_to_num(sim)

        # measured torques (a previous pass may have written back a
        # subsampled (N_used, rows) array — use it directly)
        tq_arr = np.asarray(samples["torques"])
        torq = np.array(tq_arr if tq_arr.shape[0] == N else tq_arr[idx])
        if opt["simulateTorques"]:
            torq = sim.copy()
        elif fb and torq.shape[1] < rows:
            torq = np.concatenate([sim[:, :6], torq], axis=1)

        # contact wrenches -> generalized torque contributions J^T w,
        # summed over the contact frames of the model
        contacts_sum = np.zeros((N, rows))
        num_contacts = 0
        if "contacts" in samples and np.asarray(samples["contacts"]).ndim == 0:
            cdict = samples["contacts"].item(0)
            num_contacts = len(cdict)
            frames = [(li, np.asarray(w)[idx]) for frame, w in cdict.items()
                      if (li := self.tree.link_index.get(str(frame))) is not None]
            if frames:
                lis = [li for li, _ in frames]
                W = np.stack([w for _, w in frames], axis=1)  # (N, F, 6)
                cf = self._contact_chunks(
                    lambda q, br, w: self._contact_jt_w(lis, q, br, w), Q, BR, W)
                contacts_sum += cf[:, -rows:]
        self.contactForcesSum = contacts_sum.reshape(-1)

        if fb:
            if opt["simulateTorques"]:
                torq = torq + contacts_sum
            elif not data.contacts_in_torques:
                # the measured base rows are the net base wrench: add the
                # contact contribution once (a second pass over the same
                # Data finds it written back below)
                torq[:, :6] += contacts_sum[:, :6]

        self.torques_stack = torq.reshape(-1)
        self.torquesAP_stack = (sim.reshape(-1) if (sim is not None and opt["useAPriori"])
                                else np.zeros_like(self.torques_stack))
        if num_contacts or opt["simulateTorques"]:
            # write back into a COPY of the samples dict when it still
            # aliases data.measurements (later passes must not see the
            # subsampled array as the measurement)
            if data.samples is data.measurements:
                data.samples = dict(data.measurements)
            data.samples["torques"] = torq
            if num_contacts and not opt["simulateTorques"]:
                data.contacts_in_torques = True

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
        friction blocks (mirrors the host path: zero in the base-wrench
        rows), in a buffer with 16-byte rows (ops.gram.cat_padded) that
        the Gram kernel reads in place."""
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
            F = torch.cat(blocks, dim=2)
            if self.fb:
                F = torch.cat([F.new_zeros((F.shape[0], self.fb, F.shape[2])), F], dim=1)
            Y = cat_padded([Y, F])
        return Y

    def _stage_streaming(self, samples, idx, Q, V, A, BR, BV, BA) -> dict:
        """Put the per-sample state on the device once per dataset, as the
        pieces of `_sample_pieces`, each on its mesh device; the
        simulation pass, the Gram pass and every reporting contraction
        read it from there. The base series are None for a fixed base.
        Invalidated at the top of computeRegressors."""
        st = self._staged
        if st is not None and st["N"] == len(idx):
            return st
        vsig = helpers.get_friction_sign_velocities(samples, self.opt)[idx, : self.num_dofs]
        host = dict(Q=Q, V=V, A=A, BR=BR, BV=BV, BA=BA, vsig=vsig)
        parts = [dict(sl=sl, **{k: None if a is None else self._to_dev(a[sl], dev)
                                for k, a in host.items()})
                 for sl, dev in self._sample_pieces(len(idx))]
        st = dict(N=len(idx), parts=parts)
        self._staged = st
        return st

    def _identified_chunks(self, st):
        """(slice, identified regressor piece (n, rows, P) on the piece's
        device) over the staged dataset, in sample order. The Coulomb sign
        series is derived on the device from the sign velocities (the tanh
        of helpers.get_friction_sign_series)."""
        thresh = float(self.opt.get("frictionSignThreshold", 0.02))
        for part in st["parts"]:
            Q, V, A, BR, BV, BA, vsig = (part[k] for k in ("Q", "V", "A", "BR", "BV", "BA", "vsig"))
            Y = self.engine.regressor_batch(Q, V, A, BR, BV, BA)
            yield part["sl"], self._identified_columns(Y, V, torch.tanh(vsig / thresh), vsig)

    # ------------------------------------------------------------------
    # contact wrenches: J^T w on the device, chunk by chunk
    # ------------------------------------------------------------------
    def _contact_jt_w(self, lis, Q, BR, W):
        """sum_f J_f^T w_f, (n, 6+nd), for device tensors Q (n, nd), BR
        (n, 3, 3) or None, W (n, F, 6) and link indices lis (F,)."""
        return sum((W[:, f, None, :] @ self.engine.frame_jacobian(li, Q, BR))[:, 0]
                   for f, li in enumerate(lis))

    def _contact_jacobians(self, link_index: int, Q, BR) -> np.ndarray:
        """Transposed frame Jacobians J^T, (N, 6+nd, 6), host arrays in
        and out, computed on the device in chunks."""
        return self._contact_chunks(
            lambda q, br: self.engine.frame_jacobian(link_index, q, br).transpose(1, 2), Q, BR)

    def _contact_chunks(self, fn, Q, BR, *rest) -> np.ndarray:
        """fn over the `_sample_pieces` of host arrays (Q, BR, *rest), each
        put on its device, concatenated back on the host in f64."""
        outs = []
        for sl, dev in self._sample_pieces(len(Q)):
            args = [None if a is None else self._to_dev(a[sl], dev) for a in (Q, BR, *rest)]
            outs.append(fn(*args).to(self.device))
        return torch.cat(outs).double().cpu().numpy()

    def _scan_contract(self, staged, xs) -> np.ndarray:
        """(K, N, rows) torque contractions tau_hat = Y @ x_k over the
        staged pieces."""
        xj = self._to_dev(np.stack(xs))
        outs = [torch.einsum("nrp,kp->knr", Y, xj.to(Y.device)).to(self.device)
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
        # per-output-channel Grams in ONE kernel launch per piece (a chunk,
        # or a shard of one): tau and the contact column appended to the
        # regressor, so the channel's G = Y^T Y, g = Y^T tau and
        # gcf = Y^T cf all come out of the (P+2, P+2) augmented Gram;
        # summed over pieces in f64 on the model's device
        Gaug = torch.zeros((rows, P + 2, P + 2), dtype=torch.float64, device=self.device)
        for sl, Y in self._identified_chunks(st):
            d = Y.device
            aug = cat_padded([Y, tau[sl, :, None].to(d), cf[sl, :, None].to(d)])
            Gaug += gram_batched(aug).double().to(self.device)

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
            N, rows, K = st["N"], self.N_OUT, len(missing)
            taum = self._to_dev(self.tauMeasured)
            cf = self._to_dev(self.contactForcesSum.reshape(N, rows))
            xj = self._to_dev(np.stack(missing))
            f64 = dict(dtype=torch.float64, device=self.device)
            rp, pp = torch.zeros((K, rows), **f64), torch.zeros((K, rows), **f64)
            tp, bn = torch.zeros(rows, **f64), torch.zeros(K, **f64)
            for sl, Y in self._identified_chunks(st):
                d = Y.device
                tm = taum[sl].to(d)
                pred = torch.einsum("nrp,kp->knr", Y, xj.to(d)) + cf[sl].to(d)[None]
                r = tm[None] - pred
                r2 = r * r
                rp += r2.sum(dim=1).double().to(self.device)
                pp += (pred * pred).sum(dim=1).double().to(self.device)
                tp += (tm ** 2).sum(dim=0).double().to(self.device)
                bn += torch.sqrt(r2.sum(dim=2)).sum(dim=1).double().to(self.device)
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
            staged = self._stage_streaming(self.data.samples, idx,
                                           *self._gather_state(self.data.samples, idx))
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
        fb = int(bool(self.fb))  # the cache's key: 1 for a floating base
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
        of `gramChunk` samples; each chunk's Gram (n*rows rows x P) is one
        B=1 launch of the Gram kernel, summed over chunks in f64. With
        `shardSamples` > 1 the chunk's states are the same draws, cut
        into the shard slices of `parallel.mesh.shard_slices`: one launch
        per shard on its mesh device, summed in f64 in shard order."""
        opt = self.opt
        nd = self.num_dofs
        dt = self._compute_dtype()
        grav_only = bool(opt["identifyGravityParamsOnly"])

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

        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        chunk = int(opt.get("gramChunk", 4096))
        P = self.num_identified_params
        mesh = self._sample_mesh()
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
            base = ()
            if self.fb:
                # base velocity and acceleration uniform in [0, pi), a
                # small base tilt (rpy uniform in [0, 0.1))
                b = torch.rand((c, 15), generator=gen, dtype=dt, device=self.device)
                bv, ba = np.pi * b[:, :6], np.pi * b[:, 6:12]
                if grav_only:
                    bv, ba = torch.zeros_like(bv), torch.zeros_like(ba)
                base = (rpy_to_base_rot(0.1 * b[:, 12:]), bv, ba)
            for sl, dev in zip(shard_slices(c, mesh.size), mesh.devices):
                qs, dqs, ddqs, *bs = (a[sl].to(dev) for a in (q, dq, ddq, *base))
                Y = self.engine.regressor_batch(qs, dqs, ddqs, *bs)  # (n, rows, 10L)
                Y = self._identified_columns(Y, dqs, torch.tanh(dqs / sign_thresh), dqs)
                n = sl.stop - sl.start
                G += gram_batched(Y.reshape(n * self.N_OUT, 1, P)).double().to(self.device)
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

    # ------------------------------------------------------------------
    # structural analyses
    # ------------------------------------------------------------------
    def base_equations_str(self, tol: float = 1e-6) -> list[str]:
        """Human-readable base parameter combinations (replaces the
        reference's sympy base_deps, model.py:1032-1052)."""
        eqs = []
        for i in range(self.num_base_params):
            terms = []
            for ci in np.nonzero(np.abs(self.K[i]) > tol)[0]:
                coeff = self.K[i, ci]
                # K columns are identified-space: map to the full layout
                # (they differ in gravity-only mode)
                name = self.param_names[self.identified_params[ci]]
                if abs(coeff - 1.0) < 1e-9:
                    terms.append(f"+ {name}")
                elif abs(coeff + 1.0) < 1e-9:
                    terms.append(f"- {name}")
                else:
                    terms.append(f"{coeff:+.4g}*{name}")
            eqs.append(" ".join(terms).lstrip("+ "))
        return eqs

    def structural_identifiability(self, tol: float = 1e-6) -> dict:
        """Structural identifiability triple over the inertial parameters
        (reference documentation/design_notes.md:98-103):

        - individually_identifiable: params that appear ALONE in a base
          combination (their value is determined, not just a lumped sum)
        - base_directions: rank of the structural regressor (what any
          amount of excitation can ever determine)
        - null_directions: identified inertial params minus the rank —
          the recoverable-only-with-more-sensors gap
        Friction/offset columns are excluded so the triple is comparable
        to the reference's inertial-only analysis."""
        if not hasattr(self, "K"):
            raise ValueError("structural_identifiability needs "
                             "computeRegressorLinDepsQR to have run")
        n_inertial = self.num_model_params  # 10-per-link slots
        inertial_cols = [ci for ci, p in enumerate(self.identified_params)
                         if p < n_inertial]
        inertial_set = set(inertial_cols)
        individual = set()
        inertial_rank = 0
        for row in self.K:
            nz = np.nonzero(np.abs(row) > tol)[0]
            nz_inertial = [c for c in nz if c in inertial_set]
            if not nz_inertial:
                continue  # pure friction/offset direction
            inertial_rank += 1
            if len(nz) == 1:
                individual.add(self.identified_params[nz[0]])
        n_id_inertial = len(inertial_cols)
        return {
            "individually_identifiable": len(individual),
            "individually_identifiable_params": sorted(individual),
            "base_directions": inertial_rank,
            "null_directions": n_id_inertial - inertial_rank,
            "n_inertial_params": n_id_inertial,
        }

    def sensor_placement_study(self, sensor_sets: dict, n_samples: int = 2000) -> dict:
        """Structural rank gain from adding 6-axis F/T sensors
        (reference documentation/design_notes.md:104-110).

        sensor_sets: {name: [link names]} candidate placements. For
        each, the structural Gram of the row-extended regressor
        [Y_std; Y_sensors] over random in-limit states is compared in
        inertial rank with the sensor-less baseline. Friction columns are
        excluded. The states are drawn from a torch.Generator seeded 7 on
        the model's device (the JAX package draws from jax.random key 7:
        the Grams differ in value, not in rank); each chunk's Gram is a
        plain product in the compute dtype, summed in f64 on the host."""
        opt = self.opt
        eng = self.engine
        nd = self.num_dofs
        dt = self._compute_dtype()
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
        chunk = min(int(opt.get("gramChunk", 4096)), n_samples)

        def gram_for(links: tuple[int, ...]) -> np.ndarray:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(7)
            G = np.zeros((self.num_model_params, self.num_model_params))
            done = 0
            while done < n_samples:
                u = torch.rand((3, chunk, nd), generator=gen, dtype=dt, device=self.device)
                q = lo + span * u[0]
                dq = (u[1] - 0.5) * 2 * vl
                ddq = (u[2] - 0.5) * 2 * np.pi
                base = ()
                if self.fb:
                    b = torch.rand((chunk, 15), generator=gen, dtype=dt, device=self.device)
                    base = (rpy_to_base_rot(0.1 * b[:, 12:]), np.pi * b[:, :6], np.pi * b[:, 6:12])
                rows = [eng.regressor_batch(q, dq, ddq, *base)]
                if links:
                    rows.append(eng.sensor_wrench_regressor(links, q, dq, ddq, *base))
                Yf = torch.cat(rows, dim=1).reshape(-1, self.num_model_params)
                G += (Yf.T @ Yf).double().cpu().numpy()
                done += chunk
            return G

        def rank_of(G: np.ndarray) -> int:
            _, R, _ = sla.qr(G, pivoting=True, mode="economic")
            diag = np.abs(np.diag(R))
            eps = np.finfo(self._gram_dtype).eps
            tol = max(float(opt["minTol"]), 100.0 * eps * float(diag.max(initial=0.0)))
            return int(np.sum(diag > tol))

        name_to_idx = {n: i for i, n in enumerate(self.linkNames)}
        base_rank = rank_of(gram_for(()))
        out = {
            "baseline_rank": base_rank,
            "n_inertial_params": self.num_model_params,
            "null_directions": self.num_model_params - base_rank,
            "sets": {},
        }
        for name, links in sensor_sets.items():
            idx = tuple(sorted(name_to_idx[lk] for lk in links))
            r = rank_of(gram_for(idx))
            out["sets"][name] = {"links": list(links), "rank": r, "gain": r - base_rank}
        return out

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
