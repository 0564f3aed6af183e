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
four modes), its table and the perturbed "real" model. Generating the
suspended measurements needs the simulator, the suspended-base
integrator and the measurement effect chain, which are not ported yet:
`generate_suspended_measurements` raises until they are; the study runs
on a recording made by the JAX package
(examples/data/humanoid30_suspended_cad.npz).
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


def generate_suspended_measurements(
    real_urdf: str,
    out_npz: str,
    duration: float = 40.0,
    freq: float = 50.0,
    seed: int = 0,
    attachment_frame: str = "crane_ft",
    overrides: dict | None = None,
) -> dict:
    """Simulate suspended-base measurements from the real model (crane
    ball-joint base motion + RNEA torques + effect-chain noise). Needs
    the port of the simulator, excitation/suspended.py and
    simulation/effects.py (ROADMAP.md, queue 1, items 6-7)."""
    from .identifier import not_ported

    raise not_ported("generate_suspended_measurements (the suspended-base simulator)")


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
