"""Least-squares estimation primitives (parameter stddev / WLS weights /
std recovery / essential parameters). Host-side f64 parameter-space
math; the heavy regressor work already happened on the device.

The port's own copy of flobaroid_tpu/identification/least_squares.py
(numpy and scipy only), the counterpart of the estimation methods in the
reference's identifier.py (getStdDevForParams:343,
findBaseEssentialParameters:372, identifyStandardParametersDirect:792).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def param_stddev(YBase, xBase, tauMeasured, tauEstimated, num_base_params):
    """Relative stddev per base parameter (Zak 1994; reference
    identifier.py:343-370)."""
    tauDiff = tauMeasured - tauEstimated
    r = tauMeasured.size
    rho = float(np.square(np.linalg.norm(tauDiff)))
    sigma_rho = rho / max(r - num_base_params, 1)
    C_xx = sigma_rho * np.linalg.pinv(YBase.T @ YBase)
    p_sigma = np.sqrt(np.abs(np.diag(C_xx)))
    nz = xBase != 0
    p_sigma[nz] = p_sigma[nz] / np.abs(xBase[nz])
    return p_sigma


def wls_weights(p_sigma_x: np.ndarray, n_samples: int) -> np.ndarray:
    """Per-row weights 1/sigma repeated per sample block
    (reference identifier.py:756-790)."""
    return np.repeat(np.asarray([1.0 / p_sigma_x]), n_samples, axis=0).reshape(-1)


def std_from_base(model, xBase: np.ndarray) -> np.ndarray:
    """Project base params back to standard space (reference
    identifier.py:328-341)."""
    if model.opt["useBasisProjection"]:
        xStd = model.B @ xBase
    else:
        xStd = np.linalg.pinv(model.K) @ xBase
    if model.opt["useAPriori"]:
        xStd = xStd + model.xStdModel[model.identified_params]
    return xStd


def std_direct(YStd, tau, num_base_params, xStdModel_id=None):
    """Rank-truncated-SVD direct standard estimation (Gautier 2013;
    reference identifier.py:792-829)."""
    U, s, VH = np.linalg.svd(YStd, full_matrices=False)
    nb = num_base_params
    W_pinv = VH.T[:, :nb] @ np.diag(1.0 / s[:nb]) @ U[:, :nb].T
    x = W_pinv @ tau
    if xStdModel_id is not None:
        x = xStdModel_id + x
    return x


def _eig_trunc_solve(G, g, rank):
    """Rank-truncated pseudoinverse solve from a Gram: with Y = U S V^T,
    G = Y^T Y = V S^2 V^T and g = Y^T b = V S U^T b, so the truncated
    SVD solution V_r S_r^{-1} U_r^T b equals V_r S_r^{-2} V_r^T g."""
    lam, V = np.linalg.eigh(G)  # ascending
    rank = int(min(rank, len(lam)))
    lam_r = lam[-rank:]
    V_r = V[:, -rank:]
    # f32-accumulated Grams carry O(1e-7*trace) eigenvalue noise: a
    # top-rank eigenvalue pushed near/below zero must be TRUNCATED
    # (zero contribution), not divided by a denormal
    floor = max(float(lam[-1]), 0.0) * 1e-10
    coef = np.where(lam_r > floor, (V_r.T @ g) / np.maximum(lam_r, floor), 0.0)
    return V_r @ coef


def std_direct_gram(G_std, g_tau, num_base_params, xStdModel_id=None):
    """Streaming-mode rank-truncated direct standard estimation: the
    materialized version's SVD of YStd (reference identifier.py:792-829)
    re-expressed over the accumulated Gram, so the stacked regressor is
    never needed."""
    x = _eig_trunc_solve(G_std, g_tau, num_base_params)
    if xStdModel_id is not None:
        x = xStdModel_id + x
    return x


def std_essential_gram(G_std, g_tau, xStdEssential, num_essential, xStdModel_id=None):
    """Streaming-mode weighted-SVD essential estimation: Y_e = Y D gives
    G_e = D G D and g_e = D g, so the reference's weighted truncation
    (identifier.py:831-855) runs from the Grams."""
    D = np.asarray(xStdEssential, dtype=float)
    Ge = G_std * D[:, None] * D[None, :]
    x = D * _eig_trunc_solve(Ge, D * g_tau, num_essential)
    if xStdModel_id is not None:
        x = xStdModel_id + x
    return x


def std_essential(YStd, tau, xStdEssential, num_essential, xStdModel_id=None):
    """Weighted-SVD standard-essential estimation (reference
    identifier.py:831-855)."""
    Yst_e = YStd @ np.diag(xStdEssential)
    Ue, se, VHe = sla.svd(Yst_e, full_matrices=False)
    ne = num_essential
    W_pinv = np.diag(xStdEssential) @ (VHe.T[:, :ne] @ np.diag(1.0 / se[:ne]) @ Ue[:, :ne].T)
    x = W_pinv @ tau
    if xStdModel_id is not None:
        x = xStdModel_id + x
    return x
