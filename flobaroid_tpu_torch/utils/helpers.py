"""Host-side helpers: friction sign series, physical-consistency checks
and the torque error metrics.

The port's own copy of the functions of flobaroid_tpu/utils/helpers.py
(numpy and scipy only) that the port calls.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.signal


def get_friction_sign_velocities(samples: dict[str, Any], opt: dict[str, Any]) -> np.ndarray:
    """Velocities used for the Coulomb-sign term: raw velocities low-pass
    filtered at `frictionVelocityCutoff` when available, else the pipeline
    velocities (reference: identification/helpers.py:89-133)."""
    if "velocities_for_sign" in samples:
        return samples["velocities_for_sign"]
    cutoff = float(opt.get("frictionVelocityCutoff", 25.0))
    has_raw = "velocities_raw" in samples and "frequency" in samples
    freq = float(samples["frequency"]) if has_raw else 0.0
    if has_raw and cutoff < freq / 2:
        sos = scipy.signal.butter(3, cutoff, btype="low", fs=freq, output="sos")
        v = scipy.signal.sosfiltfilt(sos, np.asarray(samples["velocities_raw"]), axis=0)
    else:
        v = np.asarray(samples["velocities"])
    samples["velocities_for_sign"] = v
    return v


def get_friction_sign_series(samples: dict[str, Any], opt: dict[str, Any]) -> np.ndarray:
    """tanh-smoothed Coulomb sign series, cached in the samples dict
    (reference: identification/helpers.py:135-157). All regressor columns,
    torque predictions and the friction refit must use this same series."""
    if "friction_sign_series" in samples:
        return samples["friction_sign_series"]
    v = get_friction_sign_velocities(samples, opt)
    thresh = float(opt.get("frictionSignThreshold", 0.02))
    s = np.tanh(v / thresh)
    samples["friction_sign_series"] = s
    return s


# ----------------------------------------------------------------------
# parameter utilities
# ----------------------------------------------------------------------
def inertia_tensor_from_vec(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[v[0], v[1], v[2]], [v[1], v[3], v[4]], [v[2], v[4], v[5]]]
    )


def pseudo_inertia(p10: np.ndarray) -> np.ndarray:
    """4x4 pseudo-inertia (density-realizability) matrix of one link:
    [[Sigma, h], [h^T, m]] with Sigma = 0.5*tr(I)*E - I.
    PSD of this matrix <=> full physical consistency (Sousa 2014 /
    Wensing 2017; used by the reference's SDP, identification/sdp.py:123-148).
    """
    m = p10[0]
    h = p10[1:4]
    I = inertia_tensor_from_vec(p10[4:10])
    Sigma = 0.5 * np.trace(I) * np.eye(3) - I
    P = np.zeros((4, 4))
    P[:3, :3] = Sigma
    P[:3, 3] = h
    P[3, :3] = h
    P[3, 3] = m
    return P


def spatial_inertia_6x6(p10: np.ndarray) -> np.ndarray:
    """Symmetric 6x6 spatial-inertia block [[I, S(h)^T], [S(h), m E]] —
    the PSD matrix the SDP enforces (reference sdp.py:123-148)."""
    m = p10[0]
    h = p10[1:4]
    I = inertia_tensor_from_vec(p10[4:10])
    S = np.array([[0, -h[2], h[1]], [h[2], 0, -h[0]], [-h[1], h[0], 0]])
    return np.block([[I, S.T], [S, m * np.eye(3)]])


def is_physical_consistent(
    params: np.ndarray, num_links: int, eps: float = 0.0, triangle: bool = False
) -> bool:
    """Physical consistency per link (massless links pass).

    triangle=False: PSD of the 6x6 spatial inertia [[I, S(h)^T],[S(h), mE]]
    — the reference's 'NoTriangle' check and exactly what its SDP enforces
    (helpers.checkPhysicalConsistencyNoTriangle / sdp.py:123-148).
    triangle=True: PSD of the 4x4 pseudo-inertia (density realizability /
    triangle inequality, the stronger Wensing condition; the reference's
    showTriangleConsistency)."""
    for i in range(num_links):
        p = params[i * 10 : i * 10 + 10]
        if np.all(np.abs(p) < 1e-12):
            continue
        M = pseudo_inertia(p) if triangle else spatial_inertia_6x6(p)
        ev = np.linalg.eigvalsh(M)
        if ev[0] < -max(eps, 1e-10 * max(1.0, abs(ev[-1]))):
            return False
    return True


# ----------------------------------------------------------------------
# error metrics (reference: identification/helpers.py:59-86)
# ----------------------------------------------------------------------
def relative_error_pct(measured: np.ndarray, estimated: np.ndarray) -> float:
    num = np.linalg.norm(measured - estimated)
    den = np.linalg.norm(measured)
    return float(100.0 * num / den) if den > 0 else float("inf")


def nrms_error_pct(measured: np.ndarray, estimated: np.ndarray, limits: np.ndarray) -> float:
    """RMS error normalized by the torque limit range per channel, in %."""
    err = np.asarray(measured) - np.asarray(estimated)
    rms = np.sqrt(np.mean(err**2, axis=0))
    rng = 2.0 * np.asarray(limits)
    rng = np.where(np.isfinite(rng) & (rng > 0), rng, np.max(np.abs(measured), axis=0) + 1e-12)
    return float(100.0 * np.mean(rms / rng))
