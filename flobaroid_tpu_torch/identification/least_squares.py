"""Standard-parameter recovery from base parameters or from the Grams.
Host-side f64 parameter-space math; the heavy regressor work already
happened on the device.

The port's own copy of the functions of
flobaroid_tpu/identification/least_squares.py (numpy only) that the
port calls (reference identifier.py:328-341 and 792-829).
"""

from __future__ import annotations

import numpy as np


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
