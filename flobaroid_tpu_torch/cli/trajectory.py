"""Optimize and sample an excitation trajectory.

    python -m flobaroid_tpu_torch.cli.trajectory --config CFG --model URDF \
        [--filename traj.npz] [--world WORLD_URDF] [--model_real URDF] [--device cpu]

Counterpart of the JAX package's root trajectory.py (reference
trajectory.py): optimize the Fourier parameters (D-optimality + limits +
collisions) on the device, sample the final kinematics, append
minimum-jerk transitions / sudden stops, or play back static postures,
run the observability analysis, and save the trajectory npz with the
reference's key contract (trajectory.py:197-266: a, b, q, nf, wf,
use_deg, static/angles, joint_limits, sampled kinematics,
unobservable_params / observability_threshold / n_observable_base_params).
"""

from __future__ import annotations

import numpy as np

from ..utils.cli import base_parser, load_cli_config, setup_device


def sample_final(spec, x, config):
    """One period of the trajectory x at the excitation frequency:
    (times, Q, V, A), evaluated on the host in f64."""
    import torch

    from ..excitation.trajectory import fourier_traj

    freq = float(config["excitationFrequency"])
    wf = float(x[0])
    duration = 2 * np.pi / wf
    n = max(int(duration * freq), 16)
    times = np.arange(n) / freq
    Q, V, A = fourier_traj(spec, torch.as_tensor(np.asarray(x, dtype=float)), times)
    return times, Q.numpy(), V.numpy(), A.numpy()


def observability(model, Q, V, A, times, config):
    """SVD observability analysis of the final trajectory's base
    regressor (reference trajectory.py:226-264): the standard params
    carried by base directions whose singular value is below
    `observabilityThreshold` times the largest, the threshold, and the
    number of observable base params. The regressor is built on the
    model's device, in its computeDtype, and stacked (materialized) for
    the SVD whatever `materializeRegressor` says."""
    from ..data import Data

    N = len(times)
    fb = 6 if config["floatingBase"] else 0
    samples = {
        "positions": Q,
        "velocities": V,
        "accelerations": A,
        "torques": np.zeros((N, model.num_dofs + fb)),
        "times": times,
        "frequency": np.float64(config["excitationFrequency"]),
        "base_rpy": np.zeros((N, 3)),
        "base_velocity": np.zeros((N, 6)),
        "base_acceleration": np.zeros((N, 6)),
    }
    sim = dict(simulateTorques=True, skipSamples=0, startOffset=0, materializeRegressor=1)
    data = Data({**config, **sim})
    data.init_from_data(samples)
    old = {k: model.opt[k] for k in sim if k in model.opt}
    model.opt.update(sim)
    try:
        model.computeRegressors(data)
    finally:
        for k in sim:
            if k in old:
                model.opt[k] = old[k]
            else:
                model.opt.pop(k)
    YB = np.asarray(model.YBase, dtype=float)
    U, S, Vt = np.linalg.svd(YB, full_matrices=False)
    thresh = float(config.get("observabilityThreshold", 1e-6))
    n_unobs = int(np.sum(S < S[0] * thresh))
    n_base = YB.shape[1]
    unobs_params = []
    if n_unobs > 0:
        V_un = Vt[-n_unobs:, :]
        energy = np.sum(V_un**2, axis=0)
        proj = model.B if config.get("useBasisProjection", 0) else model.Pb
        per_param = proj @ energy
        unobs_params = np.where(per_param > 0.5)[0].tolist()
    return unobs_params, thresh, n_base - n_unobs


def static_trajectory(model, config, x_std_real=None):
    """The static-posture trajectory: the config's `staticPostures`
    played back as given (reference trajectory.py:158-161), or postures
    chosen by the posture optimizer. Returns the npz dict to save."""
    from ..excitation.trajectory import FixedPositionTrajectory

    explicit = [] if config.get("floatingBase", 0) else [
        list(p[: model.num_dofs])
        for p in (config.get("staticPostures") or [])
        if len(p) >= model.num_dofs
    ]
    if explicit and not config.get("useStaticTrajectories", 0):
        angles = [np.asarray(p, dtype=float) for p in explicit]
    else:
        from ..excitation.posture import optimize_postures

        angles = optimize_postures(model, config, x_std_real=x_std_real)
    arr = FixedPositionTrajectory(config).initWithAngles(angles)._array
    return {
        "static": True,
        "angles": np.array([np.asarray(a) for a in angles], dtype=object),
        "positions": arr.positions,
        "velocities": arr.velocities,
        "accelerations": arr.accelerations,
        "times": arr.times,
        "frequency": np.float64(config["excitationFrequency"]),
    }


def seed_solutions(config) -> list:
    """Parameter vectors of earlier solutions (`trajectorySeedSolutions`)."""
    from ..excitation.trajectory import FourierSpec

    seeds = []
    for fn in config.get("trajectorySeedSolutions", []) or []:
        try:
            with np.load(fn, allow_pickle=True) as f:
                sp = FourierSpec(nf=tuple(int(v) for v in f["nf"]))
                seeds.append(
                    sp.join(float(f["wf"]), np.asarray(f["q"], float), list(f["a"]), list(f["b"]))
                )
        except (OSError, KeyError) as e:
            print(f"could not load seed {fn}: {e}")
    return seeds


def prior_gram(model, config, device):
    """Base Gram of prior measurements (`trajectoryPriorMeasurements`),
    on the optimizing model's base projection, or None."""
    from ..data import Data
    from ..model import Model

    yty_prior = None
    for fn in config.get("trajectoryPriorMeasurements", []) or []:
        d = Data(config)
        d.init_from_files([[fn]])
        cfg2 = dict(config, materializeRegressor=1)
        m2 = Model(cfg2, config["urdf"], regressor_init=False, device=device)
        m2.Pb = model.Pb
        m2.B = getattr(model, "B", None)
        m2.K = model.K
        m2.num_base_params = model.num_base_params
        m2.num_base_inertial_params = model.num_base_inertial_params
        cfg2["useStructuralRegressor"] = 1
        m2.computeRegressors(d)
        G = m2.YBase.T @ m2.YBase
        yty_prior = G if yty_prior is None else yty_prior + G
    return yty_prior


def with_transitions(Q, V, A, times, num_dofs, config):
    """Minimum-jerk transitions from and to the zero posture around the
    period (reference trajectory.py:150-190), then `simulateNumStops`
    sudden stops (`simulateSuddenStops` is this repo's earlier spelling)."""
    from ..excitation.trajectory import minimum_jerk_transition
    from ..simulation.effects import add_sudden_stops

    freq = float(config["excitationFrequency"])
    trans_dur = float(config.get("transitionDuration", 3.0))
    if trans_dur > 0:
        t_in, q_in, v_in, a_in = minimum_jerk_transition(np.zeros(num_dofs), Q[0], trans_dur, freq)
        t_out, q_out, v_out, a_out = minimum_jerk_transition(Q[-1], np.zeros(num_dofs), trans_dur, freq)
        times = np.concatenate([t_in, times + t_in[-1] + 1 / freq,
                                t_out + t_in[-1] + times[-1] + 2 / freq])
        Q = np.concatenate([q_in, Q, q_out])
        V = np.concatenate([v_in, V, v_out])
        A = np.concatenate([a_in, A, a_out])
    num_stops = int(config.get("simulateNumStops", 0)
                    or config.get("simulateSuddenStops", 0) or 0)
    if num_stops:
        Q, V, A = add_sudden_stops(times, Q, V, A, freq, num_stops=num_stops)
    return Q, V, A, times


def main(argv=None):
    p = base_parser("Optimize an excitation trajectory",
                    prog="python -m flobaroid_tpu_torch.cli.trajectory")
    p.add_argument("--filename", help="output trajectory npz")
    p.add_argument("--world", help="world URDF for collision checks")
    p.add_argument(
        "--model_real",
        help="ground-truth URDF: posture optimizer minimizes the "
        "identified-parameter error against it (reference parity)",
    )
    args = p.parse_args(argv)
    device = setup_device(args)
    config = load_cli_config(args)
    if args.world:
        config["worldUrdf"] = args.world

    from ..excitation.optimizer import optimize_trajectory
    from ..model import Model

    model = Model(config, config["urdf"], regressor_file=config.get("regressor"), device=device)
    config.setdefault("num_dofs", model.num_dofs)
    config.setdefault("jointNames", model.jointNames)
    traj_file = args.filename or (config["urdf"] + ".trajectory.npz")

    has_postures = not config.get("floatingBase", 0) and any(
        len(p) >= model.num_dofs for p in (config.get("staticPostures") or []))
    if config.get("useStaticTrajectories", 0) or has_postures:
        x_std_real = None
        if args.model_real:
            from ..models.urdf import load_urdf

            x_std_real = load_urdf(args.model_real).std_params()
        np.savez(traj_file, **static_trajectory(model, config, x_std_real))
        print(f"Saved static trajectory to {traj_file}")
        return

    seeds = seed_solutions(config)
    yty_prior = prior_gram(model, config, device)

    print("Optimizing trajectory (global + local)...")
    x, spec, obj, info = optimize_trajectory(model, config, yty_prior=yty_prior, seeds=seeds)
    print(f"result: f={info['f']:.2f} feasible={info['feasible']} "
          f"observable={info['n_observable']}/{model.num_base_params} "
          f"max violation={info['max_violation']:.4g}")

    times, Q, V, A = sample_final(spec, x, config)
    Q, V, A, times = with_transitions(Q, V, A, times, model.num_dofs, config)

    wf, q0, a_list, b_list = spec.ragged(x)
    save = {
        "use_deg": bool(config["useDeg"]),
        "static": False,
        "a": np.array([np.asarray(ai) for ai in a_list], dtype=object),
        "b": np.array([np.asarray(bi) for bi in b_list], dtype=object),
        "q": np.asarray(q0),
        "nf": np.asarray(spec.nf),
        "wf": float(wf),
        "positions": Q,
        "velocities": V,
        "accelerations": A,
        "times": times,
        "frequency": np.float64(config["excitationFrequency"]),
    }
    if spec.limits is not None:
        save["joint_limits"] = np.asarray(spec.limits)

    unobs, thresh, n_obs = observability(model, Q, V, A, times, config)
    save["unobservable_params"] = np.asarray(unobs, dtype=np.int64)
    save["observability_threshold"] = thresh
    save["n_observable_base_params"] = n_obs
    print(f"Observability: {n_obs}/{model.num_base_params} base params; "
          f"{len(unobs)} unobservable std params")

    np.savez(traj_file, **save)
    print(f"Saved trajectory to {traj_file}")


if __name__ == "__main__":
    main()
