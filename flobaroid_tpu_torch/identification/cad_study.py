"""CAD-regularization quality study on the suspended humanoid.

Reproduces the reference's flagship estimation-quality experiment
(reference documentation/analysis_findings.md:45-68): on a suspended
(crane ball-joint) humanoid, simulate measurements from a perturbed
"real" model, identify starting from the unperturbed CAD a-priori with
each cadRegularizationMode, and compare the L2 distance of the
identified base / standard parameters to the real model:

    uniform  >  observability  >  geometric ~= geometric+obs

(reference numbers on the 29-DOF WALK-MAN: base 4.80 / 2.82 / 2.25 /
2.26, std 4.60 / 3.41 / 3.30 / 3.31). The geometric machinery under
test is the whitened log-det Bregman divergence on the pseudo-inertia
(reference identification/sdp.py:367-448; this repo's sdp.py
`_geometric_terms`).

Port of flobaroid_tpu/identification/cad_study.py: the study itself
(`run_cad_study`, one `Identification` on the model's device serving all
four modes), its table, the perturbed "real" model, and
`generate_suspended_measurements` (the suspended-base integrator, the
inverse dynamics and the measurement effect chain of
simulation/simulator.py), which makes such a recording as the one
checked in (examples/data/humanoid30_suspended_cad.npz, made by the JAX
package).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "make_perturbed_real_urdf",
    "generate_suspended_measurements",
    "study_identification",
    "run_cad_study",
    "format_table",
    "MODE_OVERRIDES",
]

# the four CAD-prior modes of the reference study, in its table order
MODE_OVERRIDES: dict[str, dict] = {
    "uniform": dict(cadRegularizationMode="uniform"),
    "observability": dict(cadRegularizationMode="observability"),
    "geometric": dict(
        cadRegularizationMode="geometric", geometricObservabilityWeighting=0
    ),
    "geometric_obs": dict(
        cadRegularizationMode="geometric", geometricObservabilityWeighting=1
    ),
}


def make_perturbed_real_urdf(
    cad_urdf: str,
    out_path: str,
    noise: float = 0.08,
    seed: int = 0,
) -> float:
    """Write a physically consistent uniformly perturbed copy of the CAD
    model (the study's "real" robot; reference analysis_findings.md:62
    "uniformly-perturbed synthetic CAD"). Inertial parameters only —
    friction stays at CAD so parameter distances isolate the inertial
    null-space fill. Returns the relative parameter distance."""
    from ..models.urdf import load_urdf, replace_params_in_urdf
    from ..utils.helpers import is_physical_consistent

    tree = load_urdf(cad_urdf)
    pi = tree.std_params()
    rng = np.random.default_rng(seed)
    noisy = pi
    for _ in range(200):
        noisy = pi * (1.0 + noise * rng.standard_normal(pi.shape))
        noisy[0::10] = np.abs(noisy[0::10])
        # zero params (massless virtual links) stay exactly zero by the
        # multiplicative form — they remain auto-pinned in the SDP
        if is_physical_consistent(noisy, tree.num_links):
            break
    else:
        raise RuntimeError(
            f"no physically consistent perturbation found at noise={noise}"
        )
    replace_params_in_urdf(cad_urdf, out_path, noisy, tree.link_names)
    return float(np.linalg.norm(noisy - pi) / np.linalg.norm(pi))


def _excitation(tree, duration: float, freq: float, seed: int):
    """Moderate multi-harmonic joint excitation within limits — the
    conservative swing amplitudes of a real suspended experiment, not
    the random-state excitation of the CI oracle (a too-well-excited
    dataset makes every regularization mode equal)."""
    nd = tree.num_dofs
    lims = tree.joint_limits()
    lo = np.array([lims[j]["lower"] for j in tree.dof_names])
    hi = np.array([lims[j]["upper"] for j in tree.dof_names])
    lo = np.where(np.isfinite(lo), lo, -np.pi)
    hi = np.where(np.isfinite(hi), hi, np.pi)
    mid, amp0 = 0.5 * (lo + hi), 0.5 * (hi - lo)
    t = np.arange(int(duration * freq)) / freq
    rng = np.random.default_rng(seed)
    Q = np.tile(mid, (len(t), 1))
    V = np.zeros_like(Q)
    A = np.zeros_like(Q)
    for k in range(1, 4):
        w = 2 * np.pi * (0.15 * k + 0.1 * rng.random(nd))
        ph = rng.random(nd) * 2 * np.pi
        a_k = 0.25 * amp0 / k
        arg = w[None, :] * t[:, None] + ph[None, :]
        Q += a_k * np.sin(arg)
        V += a_k * w * np.cos(arg)
        A += -a_k * w**2 * np.sin(arg)
    return {"times": t, "positions": Q, "velocities": V, "accelerations": A}


def generate_suspended_measurements(
    real_urdf: str,
    out_npz: str,
    duration: float = 40.0,
    freq: float = 50.0,
    seed: int = 0,
    attachment_frame: str = "crane_ft",
    overrides: dict | None = None,
    *,
    device="cuda",
) -> dict:
    """Simulate suspended-base measurements from the real model: crane
    ball-joint base motion (excitation/suspended.py) + RNEA torques +
    effect-chain noise, on `device`. The saved npz follows the
    measurements contract (reference simulator.py:298-317)."""
    from ..models.urdf import load_urdf
    from ..simulation.simulator import simulate_measurements
    from ..utils.config import load_config

    tree = load_urdf(real_urdf)
    traj = _excitation(tree, duration, freq, seed)
    cfg = load_config(None, overrides=dict(
        floatingBase=1,
        floatingBaseAttachment="suspended",
        floatingBaseAttachmentFrame=attachment_frame,
        suspendedDamping=500.0,
        excitationFrequency=freq,
        # keep the dominant corruption sources (friction, elasticity,
        # ripple, sensor noise); drop the slow-drift effects that a real
        # identification run would warm up / calibrate away
        simulateCableForces=0, simulateGravityCompResidual=0,
        simulateThermalDrift=0, simulateTimingJitter=0,
        verbose=0,
    ))
    if overrides:
        cfg.update(overrides)
    cfg.update(urdf=real_urdf, num_dofs=tree.num_dofs,
               jointNames=list(tree.dof_names))
    meas = simulate_measurements(cfg, traj, interactive=False, device=device)
    np.savez(out_npz, **meas)
    return meas


def study_identification(
    cad_urdf: str,
    real_urdf: str,
    measurements_npz: str,
    base_overrides: dict | None = None,
    verbose: bool = False,
    *,
    device="cuda",
):
    """The study's Identification: the CAD model as the a-priori, the real
    model for the distances, the recording loaded and preprocessed, the
    study's options (streamed Grams, SDP with mass and COM limits around
    the a-priori) with `base_overrides` on top."""
    from ..utils.config import load_config
    from .identifier import Identification

    opt = load_config(None, overrides=dict(
        floatingBase=1,
        identifyFrictionSimultaneously=1,
        identifySymmetricVelFriction=1,
        useStructuralRegressor=1, randomSamples=2000,
        materializeRegressor=0, estimateWith="std",
        constrainToConsistent=1,
        useRegressorRegularization=1,
        limitOverallMass=1, limitMassRange=5.0,
        limitMassToApriori=1, limitMassAprioriBoundary=0.5,
        limitCOMToApriori=1, limitCOMAprioriBoundary=0.5,
        verbose=1 if verbose else 0,
    ))
    if base_overrides:
        opt.update(base_overrides)
    idf = Identification(dict(opt), cad_urdf, urdf_file_real=real_urdf, device=device)
    idf.data.init_from_files([[measurements_npz]])
    idf.data.preprocess(imu=False)
    return idf


def run_cad_study(
    cad_urdf: str,
    real_urdf: str,
    measurements_npz: str,
    base_overrides: dict | None = None,
    modes: dict[str, dict] | None = None,
    verbose: bool = False,
    *,
    device="cuda",
    idf=None,
) -> dict:
    """Identify with each CAD-prior mode and measure L2 distance to the
    real model over the identified parameters (reference
    analysis_findings.md:47-56). Returns
    {mode: {base_dist, std_dist, status, res_error_pct, sdp_s,
    newton_iters, launches}, "apriori": {...}}: sdp_s is the wall time of
    the mode's SDP stage, newton_iters its Newton steps, launches the
    Gram kernel launches of the mode's pass. `idf` is a
    `study_identification` of the same files to run the study on again
    (its solvers warm); without it the study builds its own.
    """
    from ..ops import gram

    modes = modes if modes is not None else MODE_OVERRIDES
    results: dict[str, dict] = {}
    # ONE Identification serves all modes: the modes differ only in the
    # SDP regularization objective (cadRegularizationMode /
    # geometricObservabilityWeighting), which initSDP_LMIs re-reads from
    # the live opt dict each estimateParameters — the Model, its
    # structural QR, the staged device inputs and the accumulated Grams
    # are mode-independent: the first mode makes the regressor pass, the
    # others reuse its Grams
    if idf is None:
        idf = study_identification(cad_urdf, real_urdf, measurements_npz, base_overrides,
                                   verbose, device=device)
    mode_keys = {k for mo in modes.values() for k in mo}
    for i, (mode, mo) in enumerate(modes.items()):
        # reset every mode-specific key (absent = its default)
        for k in mode_keys:
            idf.opt.pop(k, None)
        idf.opt.update(mo)
        launches = gram.launches
        idf.estimateParameters(reuse_regressors=i > 0)
        m = idf.model
        base_dist = float(np.linalg.norm(m.xBase - idf.xBaseReal))
        std_dist = float(
            np.linalg.norm(m.xStd - idf.xStdReal[m.identified_params])
        )
        results[mode] = {
            "base_dist": base_dist,
            "std_dist": std_dist,
            "status": idf.sdp.last_status if idf.sdp else None,
            "res_error_pct": float(idf.res_error),
            "sdp_s": idf.stage_times.get("sdp"),
            "newton_iters": (idf.sdp.last_info or {}).get("newton_iters") if idf.sdp else None,
            "launches": gram.launches - launches,
        }
        if verbose:
            print(f"[cad_study] {mode:16s} base {base_dist:7.3f} "
                  f"std {std_dist:7.3f} ({results[mode]['status']}, "
                  f"res {idf.res_error:.2f}%)")
        if "apriori" not in results:
            results["apriori"] = {
                "base_dist": float(
                    np.linalg.norm(m.xBaseModel - idf.xBaseReal)
                ),
                "std_dist": float(np.linalg.norm(
                    np.asarray(m.xStdModel[m.identified_params])
                    - idf.xStdReal[m.identified_params]
                )),
            }
    return results


def format_table(results: dict) -> str:
    lines = ["| mode | base-param distance | std-param distance |",
             "|---|---|---|"]
    for mode in ("apriori", *MODE_OVERRIDES):
        if mode in results:
            r = results[mode]
            lines.append(
                f"| {mode} | {r['base_dist']:.3f} | {r['std_dist']:.3f} |"
            )
    return "\n".join(lines)
