"""Identification pipeline orchestration.

Port of flobaroid_tpu/identification/identifier.py (the counterpart of
the reference's `Identification` class, identifier.py:41), bound to the
port's Model and Data: the regressor and Gram work runs on the model's
device, the estimation flow (OLS/WLS, SDP, std recovery, reporting) on
the host in numpy. Essential parameters, the base-wrench split,
validation and the post-identification friction refit are not ported
yet (ROADMAP.md, queue 1) and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from flobaroid_tpu.identification import least_squares as ls
from flobaroid_tpu.utils import helpers

from ..data import Data
from ..model import Model, not_ported


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
        device,
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
            from flobaroid_tpu.models.urdf import load_urdf

            tree_real = load_urdf(urdf_file_real, joint_order=self.model.jointNames)
            self.xStdReal = np.concatenate(
                [
                    tree_real.std_params(),
                    np.zeros(self.model.num_all_params - self.model.num_model_params),
                ]
            )
            if opt["identifyFrictionSimultaneously"]:
                self.model._add_friction_from_urdf(self.xStdReal, tree_real)

        if validation_file is not None:
            raise not_ported("validation (validation_file)")
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
            raise not_ported("estimateWith='base_essential' (essential parameters)")
        if estimateWith == "base":
            Pb = m.B if opt["useBasisProjection"] else m.Pb
            return np.asarray(Pb @ m.xBase, dtype=float)
        if estimateWith in ("std", "std_direct"):
            return np.asarray(m.xStd, dtype=float)
        raise ValueError(f"unknown estimateWith: {estimateWith}")

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
            cf = m.contactForcesSum if contact_forces is None else contact_forces
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
            cf_sys = None if custom_system else m.contactForcesSum
            self.identifyBaseParameters(
                np.asarray(YBase) * W[:, None], np.asarray(tau) * W,
                id_only=True,
                contact_forces=None if cf_sys is None else np.asarray(cf_sys) * W,
            )

    def getBaseParamsFromParamError(self) -> None:
        self.model.xBase += self.model.xBaseModel

    def findStdFromBaseParameters(self) -> None:
        self.model.xStd = ls.std_from_base(self.model, self.model.xBase)

    def identifyStandardParametersDirect(self) -> None:
        m = self.model
        x_id = m.xStdModel[m.identified_params] if self.opt["useAPriori"] else None
        if m.YStd is None:
            m.xStd = ls.std_direct_gram(m.G_std, m.g_tau, m.num_base_params, x_id)
        else:
            m.xStd = ls.std_direct(m.YStd, m.tau, m.num_base_params, x_id)

    # ------------------------------------------------------------------
    def estimateParameters(self) -> None:
        """Full estimation flow (reference identifier.py:857-977).
        Per-stage wall-clock lands in self.stage_times (regressor /
        estimation / sdp / reporting) for observability and the bench's
        per-stage breakdown."""
        import time as _time

        opt = self.opt
        m = self.model
        if opt["useEssentialParams"]:
            raise not_ported("useEssentialParams (essential parameters)")
        if opt.get("postIdentifyFriction", 0):
            raise not_ported("postIdentifyFriction (friction refit)")
        if self.data.num_used_samples <= m.num_identified_params * 2 and not opt.get(
            "selectingBlocks", 0
        ):
            raise ValueError(
                f"not enough samples for identification "
                f"({self.data.num_used_samples} <= 2*{m.num_identified_params})"
            )

        self.stage_times: dict[str, float] = {}
        _t = _time.perf_counter()

        def _mark(name):
            nonlocal _t
            now = _time.perf_counter()
            self.stage_times[name] = self.stage_times.get(name, 0.0) + now - _t
            _t = now

        m.computeRegressors(self.data)
        _mark("regressor_gram")

        self.identifyBaseParameters()
        _mark("ols_wls")

        if opt["constrainToConsistent"] and self.sdp is not None:
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
            _mark("sdp")
        else:
            if opt["estimateWith"] == "std_direct":
                self.identifyStandardParametersDirect()
            else:
                self.findStdFromBaseParameters()
                if opt["useAPriori"]:
                    self.getBaseParamsFromParamError()
            _mark("std_recovery")

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
        _mark("reporting")

    def _full_xstd(self) -> np.ndarray:
        """Expand xStd (identified columns) to the full parameter layout."""
        m = self.model
        if len(m.xStd) == m.num_all_params:
            return np.asarray(m.xStd, dtype=float)
        full = m.xStdModel.copy()
        for ci, p in enumerate(m.identified_params):
            full[p] = m.xStd[ci]
        return full
