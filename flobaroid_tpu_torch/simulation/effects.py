"""Differentiable measurement-corruption effects (the simulator's physics).

Counterpart of flobaroid_tpu/simulation/effects.py (reference
excitation/simulationEffects.py): 12 transforms that turn ideal
inverse-dynamics torques into realistic measurements (joint elasticity,
cogging ripple, friction incl. Stribeck, thermal drift, cable forces,
gravity-compensation residual, torque quantization, structural
deflection, backlash, encoder quantization, timing jitter, sensor
noise), plus the per-joint JointProperties derivation from the URDF.

Every effect is a vectorized torch transform over the whole (N, n)
trajectory, on the device and in the dtype of the arrays it is given —
no per-sample or per-joint Python loops. The one sequential effect
(backlash) is a clamp recursion over time: its forward pass runs as a
numpy loop on the host (N steps of n values; two launches a step on a
GPU would cost far more), and its backward pass is the same recursion
reversed, so the result is bitwise the recursion's and gradients still
flow. All smooth effects are differentiable. Quantization/rounding
effects use straight-through semantics (identity gradient). Timing
jitter, sudden stops and the sensor-noise chain are host-side numpy /
scipy, with numpy's `default_rng` draws in the JAX module's order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.signal
import torch

from ..models.urdf import RobotTree


@dataclass
class JointProperties:
    """Per-joint physical properties (reference: simulationEffects.py:18-201).

    Derived from the URDF and optionally overridden by config keys
    (simulate* keys, see simulator CLI)."""

    num_dofs: int
    viscous_friction: np.ndarray
    coulomb_friction: np.ndarray
    torque_limit: np.ndarray
    velocity_limit: np.ndarray
    link_mass: np.ndarray

    control_rate: float = 1000.0
    torque_sensor_error: float = 0.01
    torque_sensor_filter: float = 200.0
    position_filter: float = 40.0
    thermal_warmup_time: float = 0.0
    thermal_reduction: float = 0.12
    grav_comp_error_frac: float = 0.08
    stribeck_velocity: float = 0.05
    friction_sign_threshold: float = 0.02
    cable_stiffness_scale: float = 1.0

    stiction: np.ndarray = field(default_factory=lambda: np.array([]))
    backlash: np.ndarray = field(default_factory=lambda: np.array([]))
    encoder_bits: np.ndarray = field(default_factory=lambda: np.array([]))
    compliance: np.ndarray = field(default_factory=lambda: np.array([]))
    cable_stiffness: np.ndarray = field(default_factory=lambda: np.array([]))
    elasticity_freq: np.ndarray = field(default_factory=lambda: np.array([]))
    elasticity_damping: np.ndarray = field(default_factory=lambda: np.array([]))
    elasticity_gain: np.ndarray = field(default_factory=lambda: np.array([]))
    cogging_amplitude: np.ndarray = field(default_factory=lambda: np.array([]))
    torque_quant_bits: np.ndarray = field(default_factory=lambda: np.array([]))
    thermal_tau: np.ndarray = field(default_factory=lambda: np.array([]))
    grav_comp_error: np.ndarray = field(default_factory=lambda: np.array([]))

    @staticmethod
    def from_urdf(urdf_file: str | RobotTree, joint_names: list[str]) -> "JointProperties":
        """Derive all properties from URDF values: stiction ~ Fc, backlash
        ~ gear ratio, effective encoder bits = motor bits + log2(gear),
        compliance ~ 1/torque capacity, cable stiffness ~ outboard mass,
        elasticity from reflected rotor inertia, cogging ~ tau_max/gear,
        thermal tau 5-20 min (reference simulationEffects.py:75-201)."""
        from ..models.urdf import load_urdf

        tree = urdf_file if isinstance(urdf_file, RobotTree) else load_urdf(urdf_file)
        nd = len(joint_names)
        lims = tree.joint_limits()
        by_name = {tree.joints[ji].name: tree.joints[ji] for ji in tree.dof_joint_ids}

        # explicit <dynamics damping="0"/> means a frictionless joint and
        # passes through; only an ABSENT attribute gets the 1.0 default
        # (reference simulationEffects.py:125 dict-get semantics)
        fv = np.array([
            by_name[j].damping
            if (by_name[j].damping or getattr(by_name[j], "has_damping", False))
            else 1.0
            for j in joint_names
        ])
        fc = np.array([by_name[j].friction for j in joint_names])
        tau_max = np.array(
            [lims[j]["torque"] if np.isfinite(lims[j]["torque"]) else 50.0 for j in joint_names]
        )
        vel_max = np.array(
            [lims[j]["velocity"] if np.isfinite(lims[j]["velocity"]) else 3.0 for j in joint_names]
        )
        link_masses = np.array(
            [tree.links[tree.link_index[by_name[j].child]].mass for j in joint_names]
        )
        gear = np.ones(nd)
        rotor = np.zeros(nd)
        for j, name in enumerate(joint_names):
            tr = tree.transmissions.get(name)
            if tr is not None:
                gear[j] = tr.mechanical_reduction or 1.0
                rotor[j] = tr.motor_inertia

        props = JointProperties(
            num_dofs=nd,
            viscous_friction=fv,
            coulomb_friction=fc,
            torque_limit=tau_max,
            velocity_limit=vel_max,
            link_mass=link_masses,
        )

        def _norm(a):
            m = a.max()
            return a / m if m > 0 else np.ones_like(a)

        arcmin = np.pi / (180.0 * 60.0)
        props.stiction = np.where(fc > 0, fc * 0.6, tau_max * 0.003)
        props.backlash = (0.5 + 0.01 * gear) * arcmin
        base_bits = 13.0 + 3.0 * _norm(tau_max)
        props.encoder_bits = base_bits + np.log2(np.clip(gear, 1, None))
        tau_min = tau_max.min() if tau_max.min() > 0 else 1.0
        props.compliance = 1e-4 / (tau_max / tau_min)
        cum_mass = np.cumsum(link_masses[::-1])[::-1]
        props.cable_stiffness = 0.02 + 0.15 * _norm(cum_mass)
        reflected = rotor * gear**2
        total_inertia = link_masses * 0.01 + reflected
        props.elasticity_freq = 20.0 + 15.0 * (1.0 - total_inertia / (total_inertia.max() + 1e-10))
        props.elasticity_damping = np.full(nd, 0.07)
        props.elasticity_gain = 0.001 + 0.002 * _norm(props.compliance)
        props.cogging_amplitude = tau_max / (gear + 1.0) * 0.005
        motor_tau = tau_max / np.clip(gear, 1, None)
        props.torque_quant_bits = np.clip(11 + 3 * _norm(motor_tau), 11, 16).astype(float)
        motor_size = _norm(rotor) if rotor.max() > 0 else _norm(link_masses)
        props.thermal_tau = 300.0 + 900.0 * motor_size
        props.grav_comp_error = props.grav_comp_error_frac * _norm(cum_mass)
        return props

    def apply_config(self, config: dict) -> None:
        """Override properties from `simulate*` config keys
        (reference: simulator.py:159-183)."""
        self.control_rate = config.get("simulateControlRate", self.control_rate)
        self.torque_sensor_error = config.get("simulateTorqueSensorError", self.torque_sensor_error)
        self.torque_sensor_filter = config.get("simulateTorqueSensorFilter", self.torque_sensor_filter)
        self.position_filter = config.get("simulatePositionFilter", self.position_filter)
        self.thermal_warmup_time = config.get("simulateThermalWarmupTime", self.thermal_warmup_time)
        self.thermal_reduction = config.get("simulateThermalReduction", self.thermal_reduction)
        self.grav_comp_error_frac = config.get("simulateGravCompError", self.grav_comp_error_frac)
        cum_mass = np.cumsum(self.link_mass[::-1])[::-1]
        cmax = cum_mass.max()
        self.grav_comp_error = self.grav_comp_error_frac * (
            cum_mass / cmax if cmax > 0 else np.ones_like(cum_mass)
        )
        self.stribeck_velocity = config.get("simulateStribeckVelocity", self.stribeck_velocity)
        self.friction_sign_threshold = config.get(
            "simulateFrictionSignThreshold", self.friction_sign_threshold
        )
        scale = config.get("simulateCableStiffnessScale", self.cable_stiffness_scale)
        # idempotent: scale from the derived base, not cumulatively
        if not hasattr(self, "_cable_stiffness_base"):
            self._cable_stiffness_base = np.array(self.cable_stiffness)
        self.cable_stiffness_scale = float(scale)
        self.cable_stiffness = self._cable_stiffness_base * float(scale)


# ----------------------------------------------------------------------
# straight-through rounding (quantization stays differentiable)
# ----------------------------------------------------------------------
class _StraightThroughRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def st_round(x):
    """Round half to even; the gradient passes through unchanged."""
    return _StraightThroughRound.apply(x)


class _BacklashOffsets(torch.autograd.Function):
    """offset_t = clip(offset_{t-1} + delta_t, -half, half), offset_0 = 0,
    over the leading (time) axis. The recursion runs on the host; the
    backward pass walks it in reverse: an unclamped step passes its
    gradient both to delta_t and to offset_{t-1}, a clamped one to
    neither."""

    @staticmethod
    def forward(ctx, deltas, half):
        d = deltas.detach().cpu().numpy()
        h = half.detach().cpu().numpy()
        out = np.empty_like(d)
        free = np.empty(d.shape, dtype=bool)
        off = np.zeros(d.shape[1:], dtype=d.dtype)
        for t in range(d.shape[0]):
            raw = off + d[t]
            off = np.clip(raw, -h, h)
            free[t] = (raw >= -h) & (raw <= h)
            out[t] = off
        ctx.free = free
        return torch.as_tensor(out, dtype=deltas.dtype, device=deltas.device)

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().cpu().numpy()
        free = ctx.free
        gd = np.zeros_like(g)
        carry = np.zeros(g.shape[1:], dtype=g.dtype)
        for t in range(g.shape[0] - 1, -1, -1):
            carry = (carry + g[t]) * free[t]
            gd[t] = carry
        return torch.as_tensor(gd, dtype=grad.dtype, device=grad.device), None


def _t(a, like):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=like.dtype, device=like.device)


def _in_torque_cols(values, like, torque_col_offset):
    """(N, offset + n) array of `like`'s kind: zeros, `values` from
    column `torque_col_offset` on."""
    if torque_col_offset == 0:
        return values
    pad = torch.zeros((values.shape[0], torque_col_offset), dtype=like.dtype, device=like.device)
    return torch.cat([pad, values], dim=1)


# ----------------------------------------------------------------------
# effects (all take/return tensors; torque arrays are (N, fb+n))
# ----------------------------------------------------------------------
def add_joint_elasticity(torques, accelerations, freq, jp, torque_col_offset=0):
    """Damped ringing excited by jerk: convolve jerk with per-joint
    h(t) = exp(-zeta wn t) sin(wd t) (reference simulationEffects.py:248-286).
    One grouped 1-D convolution over all joints (conv1d correlates, so
    the impulse is flipped)."""
    dt = 1.0 / freq
    N = torques.shape[0]
    jerk = torch.diff(accelerations, dim=0) / dt
    jerk = torch.cat([jerk, jerk[-1:]], dim=0)  # (N, n)

    wn = 2.0 * np.pi * np.asarray(jp.elasticity_freq)
    zeta = np.asarray(jp.elasticity_damping)
    wd = wn * np.sqrt(1.0 - zeta**2)
    # common impulse length: longest decay, capped at N
    t_decay = 5.0 / (zeta * wn)
    n_imp = int(min(float(np.max(t_decay)) * freq, N))
    t_imp = np.arange(n_imp) * dt  # (K,)
    impulse = np.exp(-zeta[:, None] * wn[:, None] * t_imp) * np.sin(wd[:, None] * t_imp)

    # full convolution cut to N: out[t] = sum_k h[k] x[t-k]
    kernel = _t(impulse[:, ::-1].copy(), jerk)[:, None, :]  # (n, 1, K)
    x = torch.nn.functional.pad(jerk.T[None], (n_imp - 1, 0))  # (1, n, N + K - 1)
    vib = torch.nn.functional.conv1d(x, kernel, groups=jerk.shape[1])[0].T  # (N, n)
    return _in_torque_cols(_t(jp.elasticity_gain, jerk) * vib, torques, torque_col_offset)


def add_torque_ripple(num_samples, positions, jp, torque_col_offset=0):
    """Cogging torque at 6x/12x electrical angle
    (reference simulationEffects.py:289-320)."""
    amp = _t(jp.cogging_amplitude, positions)
    ea = positions * 4.0
    ripple = amp * (torch.sin(6 * ea) + 0.3 * torch.sin(12 * ea))
    return _in_torque_cols(ripple, positions, torque_col_offset)


def add_friction(torques, velocities, jp, torque_col_offset=0):
    """Viscous + Coulomb + Stribeck friction with tanh-smoothed sign
    (reference simulationEffects.py:497-548)."""
    fv = _t(jp.viscous_friction, velocities)
    fc = _t(jp.coulomb_friction, velocities)
    sign = torch.tanh(velocities / jp.friction_sign_threshold)
    fric = fv * velocities
    if jp.stribeck_velocity > 0:
        fs = np.asarray(jp.stiction)
        decay = torch.exp(-torch.abs(velocities) / jp.stribeck_velocity)
        fric = fric + (fc + _t(fs * (fs > 0), velocities) * decay) * sign
    else:
        fric = fric + fc * sign
    return _in_torque_cols(fric, torques, torque_col_offset)


def add_temperature_friction_drift(torques, velocities, times, jp, torque_col_offset=0):
    """Exponential friction reduction driven by per-joint velocity RMS
    (reference simulationEffects.py:637-678)."""
    n = torch.arange(times.shape[0], dtype=velocities.dtype, device=velocities.device) + 1.0
    vel_rms = torch.sqrt(torch.cumsum(velocities**2, dim=0) / n[:, None])
    vel_scale = vel_rms / (torch.abs(velocities).amax(dim=0) + 1e-10)
    eff_t = (times + jp.thermal_warmup_time)[:, None]
    tau_th = _t(jp.thermal_tau, velocities)
    red = jp.thermal_reduction
    warm = 1.0 - red * vel_scale * (1.0 - torch.exp(-eff_t / tau_th))
    # NOTE reference parity: (1 - warm) already carries `red`, so the
    # drift amplitude is fv * red^2 — the reference computes the same
    # (simulationEffects.py:668-676)
    fric_amp = _t(jp.viscous_friction, velocities) * red
    drift = -fric_amp * (1.0 - warm) * torch.sign(velocities)
    return _in_torque_cols(drift, torques, torque_col_offset)


def add_cable_forces(torques, positions, jp, torque_col_offset=0, rng=None):
    """Nonlinear spring toward random per-joint rest angles
    (reference simulationEffects.py:681-719)."""
    if rng is None:
        rng = np.random.default_rng(99)
    rest = _t(rng.uniform(-0.5, 0.5, jp.num_dofs), positions)
    k = _t(jp.cable_stiffness, positions)
    d = positions - rest
    cab = -k * d * (1.0 + 0.3 * d**2)
    return _in_torque_cols(cab, torques, torque_col_offset)


def add_gravity_compensation_residual(torques, positions, jp, torque_col_offset=0):
    """Imperfect controller gravity compensation ~ sin(q)
    (reference simulationEffects.py:721-756)."""
    cum_mass = np.cumsum(np.asarray(jp.link_mass)[::-1])[::-1]
    grav_amp = cum_mass * 9.81 * 0.15
    res = _t(np.asarray(jp.grav_comp_error) * grav_amp, positions) * torch.sin(positions)
    return _in_torque_cols(res, torques, torque_col_offset)


def add_torque_quantization(torques, jp, torque_col_offset=0):
    """Motor-drive PWM discretization; straight-through gradient
    (reference simulationEffects.py:781-800)."""
    res = _t(2.0 * np.asarray(jp.torque_limit) / (2.0 ** np.asarray(jp.torque_quant_bits)),
             torques)
    cols = torques[:, torque_col_offset:]
    quant = st_round(cols / res) * res
    return torch.cat([torques[:, :torque_col_offset], quant], dim=1)


def add_structural_deflection(positions, torques, jp, torque_col_offset=0):
    """Encoder reads motor side; link side deflects by compliance*torque
    (reference simulationEffects.py:758-778)."""
    return positions + _t(jp.compliance, positions) * torques[:, torque_col_offset:]


def add_backlash(positions, velocities, jp):
    """Gear dead-zone on direction reversal: clamp-accumulated offset,
    a recursion over time (stateful; reference simulationEffects.py:550-581)."""
    half = _t(jp.backlash, positions)
    offsets = _BacklashOffsets.apply(torch.diff(positions, dim=0), half)
    offsets = torch.cat([torch.zeros_like(positions[:1]), offsets])
    return positions - offsets


def add_encoder_quantization(positions, jp):
    """Round to encoder counts; straight-through gradient
    (reference simulationEffects.py:584-608)."""
    res = _t(2.0 * np.pi / (2.0 ** np.floor(np.asarray(jp.encoder_bits))), positions)
    return st_round(positions / res) * res


def add_timing_jitter(times, freq, rng, jp=None):
    """OS-scheduling jitter on timestamps, monotonicity enforced
    (reference simulationEffects.py:611-634). Host-side (shapes the time
    axis, not differentiable by nature)."""
    control_rate = jp.control_rate if jp is not None else 1000.0
    jitter = rng.normal(0, 0.01 / control_rate, len(times))
    jitter[0] = 0.0
    return np.maximum.accumulate(np.asarray(times) + jitter)


def add_sudden_stops(times, positions, velocities, accelerations, freq, num_stops=3, rng=None):
    """Insert cosine decel/hold/restart segments and reintegrate positions
    (reference simulationEffects.py:422-494). Host-side numpy: applied at
    trajectory build time (data-dependent segment indices)."""
    if rng is None:
        rng = np.random.default_rng(123)
    positions = np.array(positions)
    velocities = np.array(velocities)
    accelerations = np.array(accelerations)
    N = len(times)
    dt = 1.0 / freq
    margin = int(0.15 * N)
    if N - 2 * margin <= num_stops:
        return positions, velocities, accelerations
    stops = np.sort(rng.choice(range(margin, N - margin), size=num_stops, replace=False))
    d_dur, h_dur, a_dur = 0.3, 0.2, 0.3
    ds_, hs_, as_ = int(d_dur * freq), int(h_dur * freq), int(a_dur * freq)
    total = ds_ + hs_ + as_
    for s0 in stops:
        end = min(s0 + total, N)
        if end - s0 < total // 2:
            continue
        v0 = velocities[s0].copy()
        for t in range(s0, end):
            ph = t - s0
            if ph < ds_:
                s = 0.5 * (1.0 + np.cos(np.pi * ph / ds_))
                velocities[t] = v0 * s
                accelerations[t] = v0 * (-0.5 * np.pi / d_dur * np.sin(np.pi * ph / ds_))
            elif ph < ds_ + hs_:
                velocities[t] = 0.0
                accelerations[t] = 0.0
            else:
                rt = ph - ds_ - hs_
                s = 0.5 * (1.0 - np.cos(np.pi * rt / as_))
                velocities[t] = v0 * s
                accelerations[t] = v0 * (0.5 * np.pi / a_dur * np.sin(np.pi * rt / as_))
        for t in range(s0 + 1, N):
            positions[t] = positions[t - 1] + velocities[t] * dt
    return positions, velocities, accelerations


def add_sensor_noise(
    positions,
    velocities,
    torques,
    freq,
    rng,
    jp=None,
    base_rpy=None,
    base_velocity=None,
    base_acceleration=None,
):
    """Encoder/velocity/torque/IMU noise + on-board low-pass filtering
    (reference simulationEffects.py:322-419). Host-side scipy filtering
    (zero-phase filtfilt on the measurement chain)."""
    positions = np.array(positions)
    velocities = np.array(velocities)
    torques = np.array(torques)
    nd = positions.shape[1]
    off = torques.shape[1] - nd

    if jp is not None:
        enc_res = 2.0 * np.pi / (2.0 ** np.asarray(jp.encoder_bits))
    else:
        enc_res = np.full(nd, 1e-4)
    positions += rng.normal(0, 1.0, positions.shape) * enc_res

    if jp is not None:
        enc_avg = 2.0 * np.pi / (2.0 ** np.mean(jp.encoder_bits))
        vel_std = enc_avg * jp.control_rate * 0.1
    else:
        vel_std = 5e-3
    velocities += rng.normal(0, vel_std, velocities.shape)

    tfrac = jp.torque_sensor_error if jp is not None else 0.01
    tlim = np.asarray(jp.torque_limit) if jp is not None else np.full(nd, 10.0)
    torques[:, off:] += rng.normal(0, 1.0, (torques.shape[0], nd)) * (tlim * tfrac)

    nyq = freq / 2.0
    tf_hz = jp.torque_sensor_filter if jp is not None else 200.0
    if tf_hz < nyq:
        sos_t = scipy.signal.butter(4, tf_hz, btype="low", fs=freq, output="sos")
        torques = scipy.signal.sosfiltfilt(sos_t, torques, axis=0)
    pv_cut = min(jp.position_filter if jp is not None else 40.0, nyq * 0.8)
    sos_p = scipy.signal.butter(4, pv_cut, btype="low", fs=freq, output="sos")
    positions = scipy.signal.sosfiltfilt(sos_p, positions, axis=0)
    velocities = scipy.signal.sosfiltfilt(sos_p, velocities, axis=0)

    br = bv = ba = None
    if base_rpy is not None:
        br = scipy.signal.sosfiltfilt(
            sos_p, np.asarray(base_rpy) + rng.normal(0, 5e-4, base_rpy.shape), axis=0
        )
    if base_velocity is not None:
        bv = scipy.signal.sosfiltfilt(
            sos_p, np.asarray(base_velocity) + rng.normal(0, 1e-3, base_velocity.shape), axis=0
        )
    if base_acceleration is not None:
        ba = scipy.signal.sosfiltfilt(
            sos_p,
            np.asarray(base_acceleration) + rng.normal(0, 5e-3, base_acceleration.shape),
            axis=0,
        )
    return positions, velocities, torques, br, bv, ba
