"""Host-side helpers: friction sign series and the torque error metric.

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
