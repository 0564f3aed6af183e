"""Walkman-class end-to-end flow on the bundled 30-DOF humanoid.

    python -m flobaroid_tpu_torch.examples.walkman_full_flow [--device cpu]

The port's copy of examples/walkman_full_flow.py: suspended-base
D-optimal trajectory optimization -> measurement simulation (ball-joint
base + effect chain) -> SDP-constrained identification with friction.
It mirrors the reference's walkman_full scenario (BASELINE.json config
#5). The three stages are functions (`trajectory_stage`,
`simulate_stage`, `identify_stage`); `main` runs them with the JAX
script's options, reads its FLOW_PERIODS environment variable (periods of
the optimized trajectory to simulate, default 10) and prints its lines.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import MODELS, copy_model

# the JAX script's options of the trajectory and simulation stages
FLOW_OPTIONS = dict(
    floatingBase=1, floatingBaseAttachment="suspended",
    floatingBaseAttachmentFrame="crane_ft", suspendedDamping=500.0,
    useStructuralRegressor=1, randomSamples=2000,
    excitationFrequency=50.0, trajectoryPulseMin=1.0, trajectoryPulseMax=1.6,
    trajectoryDefaultNf=3, globalOptSize=12, globalOptIterations=4,
    localOptIterations=2, trajectoryTargetVelocity=0.8, verbose=0)
# ... and of the identification stage
IDENTIFY_OPTIONS = dict(
    floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0,
    limitMassToApriori=1, limitMassAprioriBoundary=0.5,
    cadRegularizationMode="observability",
    useStructuralRegressor=1, randomSamples=2000,
    materializeRegressor=0,  # stream Grams: memory-unbounded at 30 DOF
    estimateWith="std", verbose=0)
# the simulator's friction (its effect chain's truth)
FC_TRUE, FV_TRUE = 0.4, 0.7


def trajectory_stage(urdf: str, opt: dict, device="cuda"):
    """The suspended-base D-optimal trajectory: (model, x, spec, info)
    of `optimize_trajectory` on a Model of `urdf` on `device`."""
    from ..excitation.optimizer import optimize_trajectory
    from ..model import Model

    t0 = time.time()
    model = Model(dict(opt), urdf, device=device)
    print(f"model+structural QR: {time.time()-t0:.1f}s, num_base={model.num_base_params}",
          flush=True)
    t0 = time.time()
    x, spec, _obj, info = optimize_trajectory(model, dict(opt))
    print(f"suspended trajectory opt: {time.time()-t0:.1f}s {info}", flush=True)
    return model, x, spec, info


def simulate_stage(urdf: str, opt: dict, model, spec, x, periods: int, freq: float = 50.0,
                   device="cuda") -> dict:
    """`periods` periods of the trajectory x sampled at `freq` (f64 on the
    host), simulated with the suspended base and the effect chain (cable
    forces, gravity-compensation residual, thermal drift and timing
    jitter off, as in the JAX script) on `device`: the measurements."""
    from ..excitation.trajectory import fourier_traj
    from ..simulation.simulator import simulate_measurements

    times = np.arange(int(2 * np.pi / x[0] * freq) * periods) / freq
    Q, V, A = (a.numpy() for a in fourier_traj(
        spec, torch.as_tensor(np.asarray(x), dtype=torch.float64), times))
    cfg = dict(opt)
    cfg.update(urdf=urdf, num_dofs=model.num_dofs, jointNames=model.jointNames,
               simulateCableForces=0, simulateGravityCompResidual=0,
               simulateThermalDrift=0, simulateTimingJitter=0)
    t0 = time.time()
    meas = simulate_measurements(
        cfg, {"times": times, "positions": Q, "velocities": V, "accelerations": A},
        interactive=False, device=device)
    print(f"simulate (suspended + effects): {time.time()-t0:.1f}s", flush=True)
    return meas


def identify_stage(urdf: str, measurements: str, opt: dict | None = None,
                   validation: str | None = None, device="cuda"):
    """The streamed SDP-constrained identification with friction of the
    measurements npz (IDENTIFY_OPTIONS unless `opt` is given), held-out
    torques estimated when `validation` names an npz: the Identification."""
    from ..identification.identifier import Identification
    from ..utils.config import load_config

    t0 = time.time()
    idf = Identification(load_config(None, overrides=opt or IDENTIFY_OPTIONS), urdf,
                         validation_file=validation, device=device)
    idf.data.init_from_files([[measurements]])
    idf.data.preprocess(imu=False)
    idf.estimateParameters()
    if validation is not None:
        idf.estimateValidationTorques()
    print(f"identify (two-step): {time.time()-t0:.1f}s", flush=True)
    return idf


def report(idf) -> dict:
    """Print and return what the JAX script prints of an identification:
    residual, base-parameter distance to the model, the first friction
    values, consistency and the SDP status."""
    from ..utils.helpers import is_physical_consistent

    m = idf.model
    rel = float(np.linalg.norm(m.xBase - m.xBaseModel) / np.linalg.norm(m.xBaseModel))
    print(f"res_error {idf.res_error:.3f}%, base-param distance {rel:.4f}", flush=True)
    xf = idf._full_xstd()
    fs, nd = m.friction_params_start, m.num_dofs
    print(f"Fc (sim truth {FC_TRUE}):", xf[fs:fs + 8].round(3), flush=True)
    print(f"Fv (sim truth {FV_TRUE}):", xf[fs + nd:fs + nd + 8].round(3), flush=True)
    consistent = is_physical_consistent(xf[:m.num_model_params], m.num_links)
    print("consistent:", consistent, "sdp:", idf.sdp.last_status, flush=True)
    return dict(res_error=float(idf.res_error), base_dist=rel, consistent=bool(consistent),
                sdp_status=idf.sdp.last_status, fc=xf[fs:fs + nd], fv=xf[fs + nd:fs + 2 * nd])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.examples.walkman_full_flow")
    p.add_argument("--device", default="cuda",
                   help="torch device of the computation (default: cuda; cpu on request)")
    args = p.parse_args(argv)
    from ..device import resolve_device
    from ..utils.config import load_config

    device = resolve_device(args.device)
    print("device:", device, flush=True)
    tmp = tempfile.mkdtemp()
    try:
        # the bundled structural-regressor QR cache comes along (options match)
        urdf = copy_model(os.path.join(MODELS, "humanoid30.urdf"), tmp)
        opt = load_config(None, overrides=FLOW_OPTIONS)
        model, x, spec, _ = trajectory_stage(urdf, opt, device)
        # friction recovery wants 13k+ samples (BASELINE)
        periods = int(os.environ.get("FLOW_PERIODS", "10"))
        meas = simulate_stage(urdf, opt, model, spec, x, periods, device=device)
        npz = os.path.join(tmp, "m.npz")
        np.savez(npz, **meas)
        report(identify_stage(urdf, npz, device=device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("ALLDONE", flush=True)


if __name__ == "__main__":
    main()
