"""Simulate realistic measurements from a trajectory.

Counterpart of the JAX package's root `simulator.py` (reference
simulator.py:83-344): optionally simulates suspended-base motion,
computes inverse-dynamics torques on the device, applies the
measurement effect chain + sensor noise, and returns a measurements dict
with the reference's key contract (raw/target semantics,
simulator.py:298-317). The effect order and the numpy `default_rng(seed)`
draws are the JAX module's, in its order, so one seed gives the same
noise in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import Data
from ..device import resolve_device, torch_dtype
from ..model import Model
from . import effects as fx

MEASUREMENT_KEYS = {
    "positions", "positions_raw", "velocities", "velocities_raw",
    "accelerations", "torques", "torques_raw", "target_positions",
    "target_velocities", "target_accelerations", "times", "frequency",
    "contacts", "base_velocity", "base_acceleration", "base_rpy",
    "base_position",
}


def load_trajectory_data(path):
    with np.load(path, allow_pickle=True, encoding="latin1") as f:
        return {k: f[k] for k in f.files}


def simulate_measurements(config: dict, traj_data: dict, interactive: bool = True,
                          existing: dict | None = None, *, device="cuda") -> dict:
    """The full effect chain (reference simulator.py:119-245). Returns the
    measurements dict ready for np.savez. The suspended-base integration,
    the inverse dynamics and the tensor effects run on `device` in the
    config's `computeDtype`; the noise and filter chain is numpy/scipy."""
    dev = resolve_device(device)
    dtype = torch_dtype(config.get("computeDtype", "float32"))
    verbose = int(config.get("verbose", 1))
    num_dofs = int(config["num_dofs"])
    freq = float(config["excitationFrequency"])
    floating = int(config.get("floatingBase", 0))
    seed = config.get("simulateRandomSeed", 42)
    rng = np.random.default_rng(seed)

    times = np.asarray(traj_data["times"], dtype=float)
    positions = np.asarray(traj_data["positions"], dtype=float)
    velocities = np.asarray(traj_data["velocities"], dtype=float)
    accelerations = np.asarray(traj_data["accelerations"], dtype=float)
    N = len(times)
    off = 6 if floating else 0

    base_rpy = np.asarray(traj_data.get("base_rpy", np.zeros((N, 3))), dtype=float)
    base_velocity = np.asarray(traj_data.get("base_velocity", np.zeros((N, 6))), dtype=float)
    base_acceleration = np.asarray(
        traj_data.get("base_acceleration", np.zeros((N, 6))), dtype=float
    )
    base_position = None

    if floating and config.get("floatingBaseAttachment") == "suspended":
        from ..excitation.suspended import simulate_suspended_base_motion

        if verbose:
            print("Simulating suspended base dynamics...")
        base_rpy, base_velocity, base_acceleration, base_position = (
            simulate_suspended_base_motion(
                config["urdf"],
                positions,
                velocities,
                accelerations,
                times,
                attachment_frame=config.get("floatingBaseAttachmentFrame", "crane_ft"),
                damping=config.get("suspendedDamping", 2000.0),
                device=dev,
                dtype=dtype,
            )
        )

    if verbose:
        print(f"Computing inverse dynamics for {N} samples...")
    sim_data = {
        "positions": positions,
        "velocities": velocities,
        "accelerations": accelerations,
        "torques": np.zeros((N, num_dofs + off)),
        "times": times,
        "frequency": np.float64(freq),
        "base_rpy": base_rpy,
        "base_velocity": base_velocity,
        "base_acceleration": base_acceleration,
        "contacts": np.array({}),
    }
    cfg = dict(config)
    cfg.update(skipSamples=0, startOffset=0, simulateTorques=True)
    model = Model(cfg, config["urdf"], regressor_init=False, device=dev)
    data = Data(cfg)
    data.init_from_data(sim_data)
    model.computeRegressors(data, only_simulate=True)
    torques = np.array(data.samples["torques"])

    joint_names = list(config.get("jointNames", model.jointNames))
    jp = fx.JointProperties.from_urdf(model.tree, joint_names)
    jp.apply_config(config)

    if verbose:
        print("Adding simulated effects...")

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=dev)

    pos_t, vel_t, acc_t = dev_t(positions), dev_t(velocities), dev_t(accelerations)
    tq = dev_t(torques)
    tq = tq + fx.add_joint_elasticity(tq, acc_t, freq, jp, off)
    tq = tq + fx.add_torque_ripple(N, pos_t, jp, off)
    if config.get("simulateFriction", 1):
        tq = tq + fx.add_friction(tq, vel_t, jp, off)
    if config.get("simulateThermalDrift", 1):
        tq = tq + fx.add_temperature_friction_drift(tq, vel_t, dev_t(times), jp, off)
    if config.get("simulateCableForces", 1):
        tq = tq + fx.add_cable_forces(tq, pos_t, jp, off, rng=rng)
    if config.get("simulateGravityCompResidual", 1):
        tq = tq + fx.add_gravity_compensation_residual(tq, pos_t, jp, off)
    if config.get("simulateTorqueQuantization", 1):
        tq = fx.add_torque_quantization(tq, jp, off)
    pos = pos_t
    if config.get("simulateStructuralDeflection", 1):
        pos = fx.add_structural_deflection(pos, tq, jp, off)
    if config.get("simulateBacklash", 1):
        pos = fx.add_backlash(pos, vel_t, jp)
    if config.get("simulateEncoderQuantization", 1):
        pos = fx.add_encoder_quantization(pos, jp)
    torques = tq.double().cpu().numpy()
    positions_eff = pos.double().cpu().numpy()
    if config.get("simulateTimingJitter", 1):
        times = fx.add_timing_jitter(times, freq, rng, jp=jp)

    (
        positions_noisy, velocities_noisy, torques_noisy,
        base_rpy_noisy, base_velocity_noisy, base_acceleration_noisy,
    ) = fx.add_sensor_noise(
        positions_eff, velocities, torques, freq, rng, jp=jp,
        base_rpy=base_rpy, base_velocity=base_velocity,
        base_acceleration=base_acceleration,
    )

    bv = np.zeros((N, 6))
    ba = np.zeros((N, 6))
    br = np.zeros((N, 3))
    bp = np.zeros((N, 3))
    if floating:
        bv, ba, br = base_velocity_noisy, base_acceleration_noisy, base_rpy_noisy
        if base_position is not None:
            bp = base_position

    save_data = dict(existing or {})
    save_data.update(
        positions=positions_noisy,
        positions_raw=positions_noisy,
        velocities=velocities_noisy,
        velocities_raw=velocities_noisy,
        accelerations=accelerations,
        torques=torques_noisy,
        torques_raw=torques_noisy,
        target_positions=positions_eff,
        target_velocities=velocities,
        target_accelerations=accelerations,
        times=times,
        frequency=np.float64(freq),
        contacts=np.array({}),
        base_velocity=bv,
        base_acceleration=ba,
        base_rpy=br,
        base_position=bp,
    )
    if verbose:
        # summary (reference simulator.py:319-344)
        print(f"\nSimulated {N} samples")
        noise = np.sqrt(np.mean((torques_noisy - torques) ** 2))
        signal = np.sqrt(np.mean(torques**2))
        print(f"  Torque noise RMS: {noise:.4f} Nm; SNR: {signal / max(noise, 1e-12):.1f}")
    return save_data
