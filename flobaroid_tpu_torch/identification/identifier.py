"""Identification pipeline orchestration.

Port of flobaroid_tpu/identification/identifier.py (the counterpart of
the reference's `Identification` class, identifier.py:41), bound to the
port's Model and Data: the regressor and Gram work runs on the model's
device, the estimation flow (OLS/WLS, the base-wrench split, essential
parameters, SDP, std recovery, the friction refit, reporting, held-out
validation) on the host in numpy. `score_blocks` is the scoring loop of
the block selection (Venture 2009) that the identify CLI runs before
the estimation.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..data import Data
from ..model import Model
from ..models.urdf import load_urdf
from ..utils import helpers, timing
from . import least_squares as ls


def score_blocks(idf: "Identification"):
    """Block selection's scoring (Venture 2009; reference
    identifier.py:1564-1589 + data.py:205-344): ONE regressor pass over
    all measurements, then per-block base-regressor condition numbers,
    Grams and per-link subregressor condition numbers, handed to
    `Data.select_blocks_from_stats` (near-duplicate variance dropping and
    a greedy keep-if-improves pass on exact union Grams). Returns
    (conds, link_conds); the selection is in `idf.data.selected_blocks`."""
    opt = idf.opt
    if not int(opt.get("materializeRegressor", 1)):
        raise ValueError(
            "selectBlocksFromMeasurements needs materializeRegressor=1 "
            "(per-block rows are sliced from the stacked regressor)"
        )
    m = idf.model
    m.computeRegressors(idf.data)
    rows_per = m.num_dofs + m.fb
    skip = int(opt["skipSamples"]) + 1
    bs = int(opt["blockSize"])
    conds, link_conds, grams = [], [], []
    for b in range(idf.data.num_blocks()):
        # used sample u covers raw index u*skip: raw block
        # [b*bs, (b+1)*bs) maps to used [ceil(b*bs/skip),
        # ceil((b+1)*bs/skip)) — a floor-divided block length
        # drifts ~b*(bs mod skip)/skip samples by block b
        u0 = -(-(b * bs) // skip)
        u1 = -(-((b + 1) * bs) // skip)
        Yb = m.YBase[u0 * rows_per : min(u1 * rows_per, m.YBase.shape[0])]
        conds.append(float(np.linalg.cond(Yb)) if len(Yb) else 1e16)
        grams.append(Yb.T @ Yb)
        link_conds.append(m.getSubregressorsConditionNumbers(YBase=Yb))
    idf.data.select_blocks_from_stats(conds, link_conds, grams)
    return conds, link_conds


class Identification:
    def __init__(
        self,
        opt: dict[str, Any],
        urdf_file: str,
        urdf_file_real: str | None = None,
        measurements_files=None,
        regressor_file: str | None = None,
        validation_file: str | None = None,
        *,
        device="cuda",
    ):
        self.opt = opt
        # hidden experiment flags (reference identifier.py:55-69) — only
        # force them when the caller has not set them explicitly
        opt.setdefault("useBasisProjection", 0)
        opt.setdefault("orthogonalizeBasis", 1)
        opt.setdefault("useRegressorRegularization", 1)
        opt.setdefault("regularizationFactor", 1000.0)
        opt.setdefault("deleteFixedBase", 1)

        self.model = Model(opt, urdf_file, regressor_file, device=device)

        # expand dontChangeLinks to parameter indices (reference identifier.py:76-90)
        dcl = opt.get("dontChangeLinks", [])
        if dcl:
            existing = set(opt.get("dontChangeParams", []))
            for link_name in dcl:
                if link_name in self.model.linkNames:
                    li = self.model.linkNames.index(link_name)
                    existing.update(range(li * 10, li * 10 + 10))
            opt["dontChangeParams"] = sorted(existing)

        self.data = Data(opt)
        if measurements_files:
            self.data.init_from_files(measurements_files)

        self.urdf_file_real = urdf_file_real
        self.xStdReal: np.ndarray | None = None
        if urdf_file_real:
            tree_real = load_urdf(urdf_file_real, joint_order=self.model.jointNames)
            self.xStdReal = np.concatenate(
                [
                    tree_real.std_params(),
                    np.zeros(self.model.num_all_params - self.model.num_model_params),
                ]
            )
            if opt["identifyFrictionSimultaneously"]:
                self.model._add_friction_from_urdf(self.xStdReal, tree_real)

        self.validation_file = validation_file
        self._tauEstimated: np.ndarray | None = None
        self._tau_lazy_x: np.ndarray | None = None
        self._tau_lazy_gen: int | None = None
        self._tauAPriori: np.ndarray | None = None
        self._tauAP_lazy_x: np.ndarray | None = None
        self._last_resid: tuple | None = None
        self.p_sigma_x: np.ndarray | None = None
        self.res_error = 100.0

        self.sdp = None
        if opt.get("constrainToConsistent"):
            from .sdp import SDP

            self.sdp = SDP(self)

    # ------------------------------------------------------------------
    # tau_hat series are LAZY in streaming mode: the estimation flow only
    # needs residual norms (computed on device by Model.residual_stats);
    # the (N, rows) series is computed only when a renderer / plot / test
    # actually reads it
    @property
    def tauEstimated(self) -> np.ndarray | None:
        if self._tauEstimated is None and self._tau_lazy_x is not None:
            m = self.model
            self._check_lazy_gen()
            tauEst = (
                m.contract_identified(self._tau_lazy_x).reshape(-1)
                + m.contactForcesSum
            )
            self._tauEstimated = tauEst.reshape(
                self.data.num_used_samples, m.num_dofs + m.fb
            )
        return self._tauEstimated

    def _check_lazy_gen(self) -> None:
        """Lazy series contract against the model's CURRENT staged
        dataset; if the model was re-staged since estimation (e.g.
        block-selection scoring re-entry), materializing now would
        silently produce a series for the wrong data — fail loudly."""
        if getattr(self.model, "_dataset_gen", None) != self._tau_lazy_gen:
            raise RuntimeError(
                "lazy torque series requested after the model was "
                "re-staged on a different dataset; read tauEstimated/"
                "tauAPriori before reusing the Model, or re-run "
                "estimateRegressorTorques()"
            )

    @tauEstimated.setter
    def tauEstimated(self, v) -> None:
        self._tauEstimated = v
        self._tau_lazy_x = None

    @property
    def tauAPriori(self) -> np.ndarray | None:
        if self._tauAPriori is None and self._tauAP_lazy_x is not None:
            m = self.model
            self._check_lazy_gen()
            tauAP = (
                m.contract_identified(self._tauAP_lazy_x).reshape(-1)
                + m.contactForcesSum
            )
            self._tauAPriori = tauAP.reshape(
                self.data.num_used_samples, m.num_dofs + m.fb
            )
        return self._tauAPriori

    @tauAPriori.setter
    def tauAPriori(self, v) -> None:
        self._tauAPriori = v
        self._tauAP_lazy_x = None

    def _x_for(self, estimateWith: str) -> np.ndarray:
        """Identified-space parameter vector for an estimateWith mode."""
        opt = self.opt
        m = self.model
        if estimateWith == "urdf":
            return np.asarray(m.xStdModel[m.identified_params], dtype=float)
        if estimateWith == "base_essential":
            Pb = m.B if opt["useBasisProjection"] else m.Pb
            return np.asarray(Pb @ self.xBase_essential, dtype=float)
        if estimateWith == "base":
            Pb = m.B if opt["useBasisProjection"] else m.Pb
            return np.asarray(Pb @ m.xBase, dtype=float)
        if estimateWith in ("std", "std_direct"):
            return np.asarray(m.xStd, dtype=float)
        raise ValueError(f"unknown estimateWith: {estimateWith}")

    @timing.traced("reporting/torques")
    def estimateRegressorTorques(self, estimateWith: str | None = None) -> None:
        """tau_hat = Y x (+ contacts + separate friction); reference
        identifier.py:127-240."""
        opt = self.opt
        m = self.model
        if not estimateWith:
            estimateWith = opt["estimateWith"]
        streaming = m.YStd is None
        # separate (non-regressor) friction is added to the series on
        # host — those modes keep the materializing path
        sep_fric = not opt["identifyFrictionSimultaneously"] and estimateWith in (
            "std", "std_direct", "urdf"
        )
        if streaming and not sep_fric:
            x = self._x_for(estimateWith)
            st = m.residual_stats([x])
            if st is not None:
                st = st[0]
                self._last_resid = (estimateWith, st)
                self.base_error = st["bn"] / self.data.num_used_samples
                self._tauEstimated = None
                self._tau_lazy_x = x
                self._tau_lazy_gen = getattr(m, "_dataset_gen", None)
                if estimateWith == "urdf":
                    self._tauAPriori = None
                    self._tauAP_lazy_x = x
                return
        self._last_resid = None
        if streaming:
            # base/essential params expand to std space for the contraction
            tauEst = m.contract_identified(self._x_for(estimateWith)).reshape(-1)
        elif estimateWith == "urdf":
            tauEst = m.YStd @ m.xStdModel[m.identified_params]
        elif estimateWith == "base_essential":
            tauEst = m.YBase @ self.xBase_essential
        elif estimateWith == "base":
            tauEst = m.YBase @ m.xBase
        elif estimateWith in ("std", "std_direct"):
            tauEst = m.YStd @ m.xStd
        else:
            raise ValueError(f"unknown estimateWith: {estimateWith}")

        tauEst = tauEst + m.contactForcesSum

        fb = m.fb
        if not opt["identifyFrictionSimultaneously"]:
            N = self.data.num_used_samples
            skip = int(opt["skipSamples"]) + 1
            idx = np.arange(N) * skip
            vel = np.asarray(self.data.samples["velocities"])[idx, : m.num_dofs]
            sign = helpers.get_friction_sign_series(self.data.samples, opt)[idx, : m.num_dofs]
            fric = None
            if estimateWith in ("std", "std_direct") and hasattr(self, "postid_friction"):
                fric = self.postid_friction
            elif estimateWith == "urdf":
                fric = {
                    "Fc": np.array(
                        [
                            m.tree.joints[m.tree.dof_joint_ids[j]].friction
                            for j in range(m.num_dofs)
                        ]
                    ),
                    "Fv": np.array(
                        [
                            m.tree.joints[m.tree.dof_joint_ids[j]].damping
                            for j in range(m.num_dofs)
                        ]
                    ),
                    "off": np.zeros(m.num_dofs),
                }
            if fric is not None:
                t2 = tauEst.reshape(N, m.num_dofs + fb)
                t2[:, fb:] += fric["Fc"] * sign + fric["Fv"] * vel + fric["off"]
                tauEst = t2.reshape(-1)

        self.tauEstimated = tauEst.reshape(self.data.num_used_samples, m.num_dofs + fb)
        # mean per-sample residual norm: the CAD-regularization scale used
        # by the SDP (reference identifier.py:207)
        self.base_error = float(
            np.mean(np.linalg.norm(m.tauMeasured - self.tauEstimated, axis=1))
        )
        if estimateWith == "urdf":
            self.tauAPriori = self.tauEstimated

    def getStdDevForParams(self) -> np.ndarray:
        """Relative stddev per base parameter (Zak 1994; reference
        identifier.py:343-370)."""
        m = self.model
        lr = self._last_resid
        if lr is not None:
            # device-computed residual powers from the preceding
            # estimateRegressorTorques call — no series materialization
            st = lr[1]
            rho = float(np.sum(st["rp"] if self.opt["useAPriori"] else st["pp"]))
            return self._stddev_rho(rho)
        if self.opt["useAPriori"]:
            tauDiff = m.tauMeasured - self.tauEstimated
        else:
            tauDiff = self.tauEstimated
        return self._stddev(tauDiff)

    def _stddev(self, tauDiff) -> np.ndarray:
        return self._stddev_rho(float(np.square(np.linalg.norm(tauDiff))))

    def _stddev_rho(self, rho: float) -> np.ndarray:
        m = self.model
        r = self.data.num_used_samples * (m.num_dofs + m.fb)
        sigma_rho = rho / max(r - m.num_base_params, 1)
        G_base = m.G_base if m.YBase is None else m.YBase.T @ m.YBase
        C_xx = sigma_rho * np.linalg.pinv(G_base)
        p = np.sqrt(np.abs(np.diag(C_xx)))
        nz = m.xBase != 0
        p[nz] = p[nz] / np.abs(m.xBase[nz])
        return p

    # ------------------------------------------------------------------
    def identifyBaseParameters(self, YBase=None, tau=None, id_only=False,
                               contact_forces=None) -> None:
        """OLS then optional WLS re-solve (reference identifier.py:683-790)."""
        opt = self.opt
        m = self.model
        custom_system = YBase is not None
        if YBase is None:
            YBase = m.YBase
        if tau is None:
            tau = m.tau

        if opt["useBasisProjection"]:
            # Binv (= pinv(B)) — B.T only equals it for an orthonormal
            # basis; xBaseReal below uses Binv, keep both consistent
            m.xBaseModel = m.Binv @ m.xStdModel[m.identified_params]
        else:
            m.xBaseModel = m.K @ m.xStdModel[m.identified_params]
        if self.xStdReal is not None:
            if opt["useBasisProjection"]:
                self.xBaseReal = m.Binv @ self.xStdReal[m.identified_params]
            else:
                self.xBaseReal = m.K @ self.xStdReal[m.identified_params]

        # singular-value cutoff tied to the device compute dtype: entries
        # produced in f32 carry a ~eps(f32)*scale noise floor, so an
        # f64-machine-precision cutoff would keep pure-noise null
        # directions
        rcond = (
            None
            if m._gram_dtype == np.float64
            else float(100 * np.finfo(np.float32).eps)
        )
        if YBase is None and m.YBase is None:
            # streaming mode: normal equations from the accumulated Gram
            # (tau = Y x + cf  =>  G x = g_tau - g_cf); the Gram squares
            # the conditioning, so square the cutoff too
            m.xBase = np.linalg.lstsq(
                m.G_base,
                m.g_base - m.g_cf_base,
                rcond=None if rcond is None else rcond**2,
            )[0]
        else:
            m.xBase = np.linalg.lstsq(YBase, tau, rcond=rcond)[0]
            cf = contact_forces
            if cf is None:
                # the contact series of the system solved: the base-wrench
                # rows' own when that system is the one passed in
                cf = getattr(self, "_bw_contactForcesSum", m.contactForcesSum)
                if cf is not None and cf.shape[0] != YBase.shape[0]:
                    cf = m.contactForcesSum
            if cf is not None and cf.shape[0] == YBase.shape[0] and np.any(cf):
                m.xBase -= np.linalg.pinv(YBase) @ cf

        if id_only:
            return

        # sets self.base_error (used by WLS weighting and SDP regularization)
        self.estimateRegressorTorques("base")

        if opt["useWLS"]:
            # IDIM-WLS (Zak 1994 / Gautier 1997): weight each output
            # channel (joint / wrench axis) by the inverse stddev of its
            # OLS residual, then re-solve. The reference's current code
            # recycles per-parameter sigmas into the row diagonal and
            # weights only one side of the equation
            # (identifier.py:776-790); here the per-channel residual
            # noise weights BOTH sides, which is the estimator the cited
            # papers describe. (tauEstimated is fresh from the call
            # above — recomputing it here costs a full streamed
            # re-contraction at 30 DOF.)
            self.p_sigma_x = self.getStdDevForParams()
            lr = self._last_resid
            if custom_system:
                # weight the SYSTEM that was passed in: its channels and
                # residuals — the re-solve below reuses it too
                res = np.asarray(tau - YBase @ m.xBase).reshape(
                    self.data.num_used_samples, -1
                )
                sigma_ch = np.sqrt(np.mean(res**2, axis=0))
            elif lr is not None and lr[0] == "base":
                # per-channel residual powers straight from the device
                # stats of the estimateRegressorTorques("base") call
                sigma_ch = np.sqrt(lr[1]["rp"] / self.data.num_used_samples)
            else:
                res = (m.tauMeasured - self.tauEstimated).reshape(
                    self.data.num_used_samples, m.num_dofs + m.fb
                )
                sigma_ch = np.sqrt(np.mean(res**2, axis=0))
            w_ch = 1.0 / np.maximum(sigma_ch, 1e-12)
            if m.YBase is None:
                # streaming mode: sigmas come from the streamed residual
                # above; NOT from Gram identities — those cancel
                # catastrophically in f32 (residual power is a tiny
                # difference of huge accumulated scalars). Reweighting is
                # a rescale of the per-channel Gram blocks.
                m._set_streaming_aggregates(w_ch**2)
                self.identifyBaseParameters(id_only=True)
                # restore the measurement-metric aggregates so later
                # residual/σ computations are physical
                m._set_streaming_aggregates(np.ones_like(w_ch))
                return
            # solve on WEIGHTED COPIES: the originals stay in the
            # measurement metric so later residuals/plots are physical.
            # The contact correction for W(Yx) = W(tau - cf) needs the
            # WEIGHTED cf
            W = np.tile(w_ch, self.data.num_used_samples)
            if custom_system:
                cf_sys = getattr(self, "_bw_contactForcesSum", None)
                if cf_sys is not None and cf_sys.shape[0] != YBase.shape[0]:
                    cf_sys = None
            else:
                cf_sys = m.contactForcesSum
            self.identifyBaseParameters(
                np.asarray(YBase) * W[:, None], np.asarray(tau) * W,
                id_only=True,
                contact_forces=None if cf_sys is None else np.asarray(cf_sys) * W,
            )

    def _extractBaseWrenchRows(self):
        """Ayusawa base-wrench-only equations + optional per-file inverse
        noise weighting (reference identifier.py:617-681)."""
        m = self.model
        if m.YStd is None:
            raise ValueError(
                "useBaseWrenchForBaseParams needs the stacked regressor "
                "(set materializeRegressor=1): the base-wrench row subset "
                "cannot be sliced from streamed Grams"
            )
        nd, fb = m.num_dofs, 6
        block = nd + fb
        N = self.data.num_used_samples
        rows = (np.arange(N)[:, None] * block + np.arange(fb)).reshape(-1)
        YStd_bw = m.YStd[rows, :]
        YBase_bw = YStd_bw @ (m.B if self.opt["useBasisProjection"] else m.Pb)
        tau_bw = (m.tau if self.opt["useAPriori"] else m.torques_stack)[rows]
        self._bw_contactForcesSum = m.contactForcesSum[rows]

        fbnd = getattr(self.data, "file_boundaries", [0])
        if self.opt.get("useTrajectoryWeighting", 0) and len(fbnd) > 2:
            skip = int(self.opt["skipSamples"]) + 1
            x_pre = np.linalg.lstsq(YBase_bw, tau_bw, rcond=None)[0]
            res2d = (tau_bw - YBase_bw @ x_pre).reshape(N, fb)
            loaded_idx = np.arange(N) * skip
            file_idx = np.searchsorted(fbnd, loaded_idx, side="right") - 1
            n_files = len(fbnd) - 1
            sigma = np.ones((n_files, fb))
            for k in range(n_files):
                msk = file_idx == k
                if np.count_nonzero(msk) > fb:
                    sigma[k] = np.sqrt(np.mean(res2d[msk] ** 2, axis=0))
            wts = np.mean(sigma) / np.maximum(sigma, 1e-12)
            rw = wts[file_idx].reshape(-1)
            YBase_bw = YBase_bw * rw[:, None]
            tau_bw = tau_bw * rw
            self._bw_contactForcesSum = self._bw_contactForcesSum * rw
        return YBase_bw, tau_bw

    def getBaseParamsFromParamError(self) -> None:
        self.model.xBase += self.model.xBaseModel
        if self.opt["useEssentialParams"] and hasattr(self, "xBase_essential"):
            self.xBase_essential[self.baseEssentialIdx] += self.model.xBaseModel[
                self.baseEssentialIdx
            ]

    def findStdFromBaseParameters(self) -> None:
        self.model.xStd = ls.std_from_base(self.model, self.model.xBase)

    # ------------------------------------------------------------------
    # essential parameters (Pham 1991 / Gautier 2013)
    # ------------------------------------------------------------------
    def findBaseEssentialParameters(self) -> None:
        """Iteratively drop the base param with largest relative stddev
        until max/min stddev ratio < 30 (reference identifier.py:372-529)."""
        m = self.model
        if m.YBase is None:
            return self._findBaseEssentialParametersStreaming()
        xBase_orig = m.xBase.copy()
        YBase_orig = m.YBase.copy()
        base_idx = list(range(m.num_base_params))
        not_essential: list[int] = []
        prev_sigma = None
        prev_xBase = m.xBase.copy()
        while True:
            self.estimateRegressorTorques("base")
            p_sigma = self.getStdDevForParams()
            ratio = np.max(p_sigma) / max(np.min(p_sigma), 1e-300)
            if ratio < 30 or len(base_idx) <= 2:
                break
            prev_sigma = p_sigma
            k = int(np.argmax(p_sigma))
            not_essential.append(base_idx[k])
            prev_xBase = m.xBase.copy()
            m.xBase = np.delete(m.xBase, k, 0)
            del base_idx[k]
            m.YBase = np.delete(m.YBase, k, 1)
            self.identifyBaseParameters(id_only=True)
        if not_essential:
            # the last deleted parameter brought the ratio under the
            # threshold; keep it (reference identifier.py:512)
            not_essential.pop()
        self.p_sigma_x = prev_sigma if prev_sigma is not None else self.getStdDevForParams()
        self.baseNonEssentialIdx = not_essential
        self.baseEssentialIdx = [x for x in range(m.num_base_params) if x not in not_essential]
        self.num_essential_params = len(self.baseEssentialIdx)
        # prev_xBase was saved just before the last deletion, so it lines
        # up with baseEssentialIdx by construction
        self.xBase_essential = np.zeros(m.num_base_params)
        self.xBase_essential[self.baseEssentialIdx] = prev_xBase
        m.YBase = YBase_orig
        m.xBase = xBase_orig

    def _findBaseEssentialParametersStreaming(self) -> None:
        """Essential-parameter deletion from the accumulated Grams
        (materializeRegressor=0): C_xx is proportional to pinv(G_kept),
        and the residual power rho scales ALL sigmas uniformly — the
        deletion ORDER and the max/min stop ratio are rho-independent.
        rho is computed once from a single streamed contraction so the
        reported sigma magnitudes stay physical (a per-iteration
        Gram-identity rho cancels catastrophically in f32)."""
        m = self.model
        xBase_orig = m.xBase.copy()
        self.estimateRegressorTorques("base")
        r = self.data.num_used_samples * (m.num_dofs + m.fb)
        lr = self._last_resid
        if lr is not None and lr[0] == "base":
            # device residual powers from the call above — no (N, rows)
            # series materialization
            rho = float(np.sum(lr[1]["rp"]))
        else:
            rho = float(np.square(np.linalg.norm(m.tauMeasured - self.tauEstimated)))
        G0 = np.asarray(m.G_base)
        rhs0 = np.asarray(m.g_base - m.g_cf_base)
        kept = list(range(m.num_base_params))
        not_essential: list[int] = []
        prev_sigma = None
        prev_xBase = m.xBase.copy()
        while True:
            G = G0[np.ix_(kept, kept)]
            sigma_rho = rho / max(r - len(kept), 1)
            p_sigma = np.sqrt(np.abs(np.diag(sigma_rho * np.linalg.pinv(G))))
            nz = m.xBase != 0
            p_sigma[nz] = p_sigma[nz] / np.abs(m.xBase[nz])
            ratio = np.max(p_sigma) / max(np.min(p_sigma), 1e-300)
            if ratio < 30 or len(kept) <= 2:
                break
            prev_sigma = p_sigma
            k = int(np.argmax(p_sigma))
            not_essential.append(kept[k])
            prev_xBase = m.xBase.copy()
            del kept[k]
            G = G0[np.ix_(kept, kept)]
            m.xBase = np.linalg.lstsq(G, rhs0[kept], rcond=None)[0]
        if not_essential:
            # the last deleted parameter brought the ratio under the
            # threshold; keep it (reference identifier.py:512)
            not_essential.pop()
        self.p_sigma_x = prev_sigma if prev_sigma is not None else p_sigma
        self.baseNonEssentialIdx = not_essential
        self.baseEssentialIdx = [
            x for x in range(m.num_base_params) if x not in not_essential
        ]
        self.num_essential_params = len(self.baseEssentialIdx)
        self.xBase_essential = np.zeros(m.num_base_params)
        self.xBase_essential[self.baseEssentialIdx] = prev_xBase
        m.xBase = xBase_orig

    def findStdFromBaseEssParameters(self) -> None:
        """Map essential base -> essential std columns (reference
        identifier.py:531-615)."""
        m = self.model
        self.stdEssentialIdx = np.asarray(m.independent_cols)[self.baseEssentialIdx]
        if self.opt["useDependents"]:
            deps: list[int] = []
            for i in self.baseEssentialIdx:
                for ci in np.nonzero(np.abs(m.K[i]) > float(self.opt["minTol"]))[0]:
                    if ci not in deps:
                        deps.append(int(ci))
            self.stdEssentialIdx = np.unique(
                np.concatenate((self.stdEssentialIdx, np.asarray(deps, dtype=int)))
            )
        self.stdNonEssentialIdx = [
            x for x in range(m.num_identified_params) if x not in set(self.stdEssentialIdx.tolist())
        ]
        self.xStdEssential = np.zeros(m.num_identified_params)
        if self.opt["useDependents"]:
            xw = m.xStdModel[m.identified_params].copy()
            xw[xw == 0] = 0.1
            self.xStdEssential = xw
            self.xStdEssential[self.stdNonEssentialIdx] = 0
        else:
            take = self.xBase_essential[self.baseEssentialIdx][: len(self.stdEssentialIdx)]
            self.xStdEssential[self.stdEssentialIdx[: len(take)]] = take

    def identifyStandardEssentialParameters(self) -> None:
        m = self.model
        x_id = m.xStdModel[m.identified_params] if self.opt["useAPriori"] else None
        if m.YStd is None:
            m.xStd = ls.std_essential_gram(
                m.G_std, m.g_tau, self.xStdEssential,
                self.num_essential_params, x_id,
            )
        else:
            m.xStd = ls.std_essential(
                m.YStd, m.tau, self.xStdEssential, self.num_essential_params, x_id
            )

    def identifyStandardParametersDirect(self) -> None:
        m = self.model
        x_id = m.xStdModel[m.identified_params] if self.opt["useAPriori"] else None
        if m.YStd is None:
            m.xStd = ls.std_direct_gram(m.G_std, m.g_tau, m.num_base_params, x_id)
        else:
            m.xStd = ls.std_direct(m.YStd, m.tau, m.num_base_params, x_id)

    # ------------------------------------------------------------------
    def _postIdentifyFriction(self) -> None:
        """Two-step friction refit from the inertial residual (reference
        identifier.py:979-1168): per-joint OLS of residual on
        [sign, v, 1], Swevers dead zone, Fv Tikhonov prior, Fv>=0 clamp,
        write-back into xStd friction slots when the layout permits."""
        opt = self.opt
        m = self.model
        nd, fb = m.num_dofs, m.fb
        N = self.data.num_used_samples
        skip = int(opt["skipSamples"]) + 1
        idx = np.arange(N) * skip

        if m.YStd is None:
            num_inertial = min(m.num_model_params, m.num_identified_params)
            x_in = np.zeros(m.num_identified_params)
            x_in[:num_inertial] = m.xStd[:num_inertial]
            tau_inertial = m.contract_identified(x_in).reshape(-1)
        else:
            num_inertial = min(m.num_model_params, m.YStd.shape[1])
            tau_inertial = m.YStd[:, :num_inertial] @ m.xStd[:num_inertial]
        residual2d = (m.torques_stack - tau_inertial).reshape(N, nd + fb)

        vel = np.asarray(self.data.samples["velocities"])[idx, :nd]
        vsig = helpers.get_friction_sign_velocities(self.data.samples, opt)[idx, :nd]
        sign = helpers.get_friction_sign_series(self.data.samples, opt)[idx, :nd]

        deadzone = float(opt.get("frictionSwerversDeadZone", 0.0) or opt.get("frictionVelocityDeadZone", 0.0))
        keep_masks = []
        fv_energy = np.zeros(nd)
        for j in range(nd):
            if deadzone > 0:
                keep = np.abs(vsig[:, j]) >= deadzone
                if np.count_nonzero(keep) < 30 or not (vsig[keep, j] > 0).any() or not (vsig[keep, j] < 0).any():
                    keep = np.ones(N, dtype=bool)
            else:
                keep = np.ones(N, dtype=bool)
            keep_masks.append(keep)
            fv_energy[j] = float(np.sum(vel[keep, j] ** 2))

        alpha = float(opt.get("frictionFvRegularizationRelative", 0.0))
        lam = alpha * float(np.median(fv_energy)) if alpha > 0 else float(opt.get("frictionFvRegularization", 0.0))
        fv_ap = np.array([m.tree.joints[m.tree.dof_joint_ids[j]].damping for j in range(nd)])

        self.postid_friction = {"Fc": np.zeros(nd), "Fv": np.zeros(nd), "off": np.zeros(nd)}
        for j in range(nd):
            keep = keep_masks[j]
            A = np.column_stack([sign[keep, j], vel[keep, j], np.ones(np.count_nonzero(keep))])
            b = residual2d[keep, fb + j]
            if lam > 0:
                w = np.sqrt(lam)
                A = np.vstack((A, [0.0, w, 0.0]))
                b = np.append(b, w * fv_ap[j])
            fc, fv, off = np.linalg.lstsq(A, b, rcond=None)[0]
            self.postid_friction["Fc"][j] = fc
            self.postid_friction["Fv"][j] = max(fv, 0.0)
            self.postid_friction["off"][j] = off

        if (
            opt.get("identifyFrictionSimultaneously", False)
            and opt["identifySymmetricVelFriction"]
            and opt.get("stribeckVelocity", 0) == 0
            and len(m.xStd) == m.num_all_params
        ):
            fs = m.friction_params_start
            m.xStd[fs : fs + nd] = self.postid_friction["Fc"]
            m.xStd[fs + nd : fs + 2 * nd] = self.postid_friction["Fv"]
            m.xStd[fs + 2 * nd : fs + 3 * nd] = self.postid_friction["off"]

    # ------------------------------------------------------------------
    def estimateParameters(self, reuse_regressors: bool = False) -> None:
        """Full estimation flow (reference identifier.py:857-977).
        Per-stage host seconds land in self.stage_times (regressor_gram /
        ols_wls / essential / sdp / std_recovery / reporting); while a
        profiler records, the pass is the root span `identify` and each
        stage its span `identify/<stage>`. `reuse_regressors` skips the
        regressor pass when the model still holds this Data's regressors
        or Grams from an earlier pass (a sweep over estimation options on
        one recording, as the CAD study's modes)."""
        opt = self.opt
        m = self.model
        if self.data.num_used_samples <= m.num_identified_params * 2 and not opt.get(
            "selectingBlocks", 0
        ):
            raise ValueError(
                f"not enough samples for identification "
                f"({self.data.num_used_samples} <= 2*{m.num_identified_params})"
            )

        self.stage_times: dict[str, float] = {}
        stage = timing.Stages(self.stage_times, "identify")
        with timing.span("identify", N=self.data.num_used_samples):
            with stage("regressor_gram"):
                if not (reuse_regressors and getattr(m, "data", None) is self.data
                        and m.tau is not None):
                    m.computeRegressors(self.data)

            if opt["useEssentialParams"]:
                with stage("ols_wls"):
                    self.identifyBaseParameters()
                with stage("essential"):
                    self.findBaseEssentialParameters()
                    if opt["useAPriori"]:
                        self.getBaseParamsFromParamError()
                    self.findStdFromBaseEssParameters()
                    self.identifyStandardEssentialParameters()
            else:
                with stage("ols_wls"):
                    if opt["floatingBase"] and opt.get("useBaseWrenchForBaseParams", 0):
                        self.identifyBaseParameters(*self._extractBaseWrenchRows())
                    else:
                        self.identifyBaseParameters()
                if opt["constrainToConsistent"] and self.sdp is not None:
                    with stage("sdp"):
                        self._identifyConsistentParameters()
                else:
                    with stage("std_recovery"):
                        if opt["estimateWith"] == "std_direct":
                            self.identifyStandardParametersDirect()
                        else:
                            self.findStdFromBaseParameters()
                            if opt["useAPriori"]:
                                self.getBaseParamsFromParamError()

            with stage("reporting"):
                self._report()

    def _identifyConsistentParameters(self) -> None:
        """The SDP stage: physically consistent standard parameters."""
        opt = self.opt
        m = self.model
        if opt["useAPriori"]:
            self.getBaseParamsFromParamError()
        self.sdp.initSDP_LMIs(self)
        if opt["identifyClosestToCAD"]:
            self.sdp.identifyFeasibleStandardParameters(self)
            if not np.allclose(m.xStd, m.xStdModel[m.identified_params]):
                m.xBase = (
                    m.Binv @ m.xStd
                    if opt["useBasisProjection"]
                    else m.K @ m.xStd
                )
                self.sdp.findFeasibleStdFromFeasibleBase(self, m.xBase)
        else:
            if opt["estimateWith"] == "std_direct":
                self.sdp.identifyFeasibleStandardParametersDirect(self)
            else:
                self.sdp.identifyFeasibleStandardParameters(self)
            m.xBase = (
                m.Binv @ m.xStd if opt["useBasisProjection"] else m.K @ m.xStd
            )

    def _report(self) -> None:
        """The friction refit and the reporting pass: the estimated
        torques with the a-priori and the identified parameters, and
        res_error."""
        opt = self.opt
        m = self.model
        if opt.get("postIdentifyFriction", 0):
            if opt["floatingBase"] or opt.get("identifyFrictionSimultaneously", 0):
                self._postIdentifyFriction()

        if m.YStd is None:
            # streaming: both reporting quantities (a-priori + identified)
            # in ONE device pass — residual stats (series stay lazy), else
            # the fused contraction prefetch
            xs = [np.asarray(m.xStdModel[m.identified_params], dtype=float)]
            ew = opt["estimateWith"]
            if ew in ("std", "std_direct") and len(m.xStd):
                xs.append(np.asarray(m.xStd, dtype=float))
            elif ew == "base":
                Pb = m.B if opt["useBasisProjection"] else m.Pb
                xs.append(np.asarray(Pb @ m.xBase, dtype=float))
            elif ew == "base_essential" and hasattr(self, "xBase_essential"):
                Pb = m.B if opt["useBasisProjection"] else m.Pb
                xs.append(np.asarray(Pb @ self.xBase_essential, dtype=float))
            # split by the SAME per-mode gate estimateRegressorTorques
            # uses: modes with separate (host-added) friction materialize
            # their series; the rest are served by device stats — warming
            # exactly one path per mode (no double data pass)
            sep = not opt["identifyFrictionSimultaneously"]
            modes = ["urdf"] + ([ew] if len(xs) > 1 else [])
            mats = [x for mo, x in zip(modes, xs)
                    if sep and mo in ("std", "std_direct", "urdf")]
            stats = [x for mo, x in zip(modes, xs)
                     if not (sep and mo in ("std", "std_direct", "urdf"))]
            if stats and m.residual_stats(stats) is None:
                mats = xs
            if mats:
                m.prefetch_contractions(mats)
        self.estimateRegressorTorques("urdf")
        self.estimateRegressorTorques()
        lr = self._last_resid
        if lr is not None:
            st = lr[1]
            den = float(np.sqrt(np.sum(st["tp"])))
            self.res_error = (
                float(100.0 * np.sqrt(np.sum(st["rp"])) / den)
                if den > 0 else float("inf")
            )
        else:
            self.res_error = helpers.relative_error_pct(
                m.tauMeasured, self.tauEstimated
            )

    def estimateValidationTorques(self) -> None:
        """Predict held-out measurements with the identified params
        (reference identifier.py:241-320), through the model's device
        simulation."""
        if self.validation_file is None:
            return
        with np.load(self.validation_file, allow_pickle=True, encoding="latin1") as f:
            v = {k: f[k] for k in f.files}
        m = self.model
        params = m.xStdModel if self.opt["estimateWith"] == "urdf" else self._full_xstd()
        # the reference pins validation subsampling to skipSamples=8
        # regardless of the config (reference identifier.py:271-272);
        # short validation files fall back to using every sample
        total = v["positions"].shape[0]
        skip = 8 + 1 if total >= 9 else 1
        idx = np.arange(total // skip) * skip
        sim = m.simulate_dynamics(v, idx, params)
        tauM = np.asarray(v["torques"])[idx]
        if self.opt["floatingBase"] and tauM.shape[1] == m.num_dofs:
            # joint-only measurements: the base rows compare trivially
            tauM = np.concatenate((sim[:, :6], tauM), axis=1)
        self.tauEstimatedValidation = sim
        self.tauMeasuredValidation = tauM
        self.Tv = np.asarray(v["times"])[idx]
        self.val_error = helpers.relative_error_pct(tauM, sim)
        self.val_residual = float(np.mean(np.linalg.norm(sim - tauM, axis=1)))
        limits = np.array([m.limits[j]["torque"] for j in m.jointNames])
        if self.opt["floatingBase"]:
            limits = np.concatenate([np.full(6, np.nan), limits])
        self.val_nrms = helpers.nrms_error_pct(tauM, sim, limits)

    def _full_xstd(self) -> np.ndarray:
        """Expand xStd (identified columns) to the full parameter layout."""
        m = self.model
        if len(m.xStd) == m.num_all_params:
            return np.asarray(m.xStd, dtype=float)
        full = m.xStdModel.copy()
        for ci, p in enumerate(m.identified_params):
            full[p] = m.xStd[ci]
        return full
