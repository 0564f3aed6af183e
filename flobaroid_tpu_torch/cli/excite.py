"""Drive a real robot through an excitation trajectory and record
measurements.

    python -m flobaroid_tpu_torch.cli.excite --config CFG --model URDF \
        [--trajectory traj.npz] [--filename meas.npz] [--periods N] \
        [--dryrun] [--plot]

Counterpart of the JAX package's root excite.py (reference
excite.py:51-156): load the trajectory npz (Fourier / sampled-array /
static postures), dispatch to the configured communication back-end
(`exciteMethod`: 'yarp', 'ros', or 'tcp' for the in-repo native
excitation_server), preprocess the recordings (filter + differentiate)
and save a measurements npz. Everything here is host work (numpy and
scipy), so the command has no `--device` and runs on a robot host
without a card.
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.cli import base_parser, load_cli_config


def main(argv=None):
    p = base_parser("Excite a robot and record measurements",
                    prog="python -m flobaroid_tpu_torch.cli.excite", device=False)
    p.add_argument("--trajectory", help="trajectory npz file")
    p.add_argument("--filename", default="measurements.npz", help="output npz")
    p.add_argument("--periods", type=int, default=1)
    p.add_argument("--dryrun", action="store_true", help="only load the trajectory")
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)
    config = load_cli_config(args)
    config["args"] = args

    from ..data import Data
    from ..excitation.trajectory import (
        ArrayTrajectory,
        FixedPositionTrajectory,
    )
    from ..models.urdf import load_urdf

    tree = load_urdf(config["urdf"])
    config.setdefault("num_dofs", tree.num_dofs)
    config.setdefault("jointNames", tree.dof_names)

    traj_file = args.trajectory or (config["urdf"] + ".trajectory.npz")
    try:
        tf = np.load(traj_file, encoding="latin1", allow_pickle=True)
    except OSError:
        print(f"No trajectory file found, can't excite ({traj_file})!")
        sys.exit(1)
    if "static" in tf and tf["static"]:
        trajectory = FixedPositionTrajectory(config).initWithAngles(list(tf["angles"]))
        print(f"using static postures from {traj_file}")
    elif "positions" in tf.files:
        trajectory = ArrayTrajectory(
            tf["times"], tf["positions"], tf["velocities"], tf["accelerations"]
        )
        print(f"using trajectory from {traj_file} ({len(tf['times'])} samples)")
    else:
        print(f"Error: {traj_file} has no saved positions. Regenerate with flobaroid_tpu_torch.cli.trajectory.")
        sys.exit(1)

    if args.dryrun:
        print("dryrun: trajectory loaded OK")
        return

    method = config.get("exciteMethod")
    if not method:
        print("Error: exciteMethod must be set to 'yarp', 'ros' or 'tcp'.")
        print("For simulated measurements, use flobaroid_tpu_torch.cli.simulator instead.")
        sys.exit(1)

    out: dict = {}
    if method == "yarp":
        from ..robot_io import yarp_gym

        yarp_gym.main(config, trajectory, out)
    elif method == "ros":
        from ..robot_io import ros_moveit

        ros_moveit.main(config, trajectory, out)
    elif method == "tcp":
        from ..robot_io import tcp_bridge

        tcp_bridge.main(config, trajectory, out)
    else:
        print(f"Error: unknown exciteMethod '{method}'.")
        sys.exit(1)

    # preprocess (filter + differentiate) via the Data pipeline
    samples = {
        "positions": out["Q"],
        "velocities": out["V"],
        "accelerations": np.zeros_like(out["V"]),
        "torques": out["Tau"],
        "times": out["T"],
        "frequency": np.float64(out["measured_frequency"]),
    }
    data = Data(config)
    data.init_from_data(samples)
    data.preprocess()

    if args.plot:
        # headless plot of measured vs commanded (reference excite.py
        # plots recordings after the run); written next to the output
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nd = out["Q"].shape[1]
        fig, axes = plt.subplots(2, 1, figsize=(12, 7), constrained_layout=True)
        for j in range(nd):
            axes[0].plot(out["T"], out["Q"][:, j], lw=0.7)
            axes[0].plot(out["T"], out["Qsent"][:, j], lw=0.5, ls="--", alpha=0.6)
        axes[0].set_title("positions: measured (solid) vs commanded (dashed)")
        axes[0].grid(alpha=0.3)
        for j in range(nd):
            axes[1].plot(out["T"], out["Tau"][:, j], lw=0.7)
        axes[1].set_title("measured torques")
        axes[1].grid(alpha=0.3)
        plot_file = args.filename.rsplit(".", 1)[0] + "_plot.png"
        fig.savefig(plot_file, dpi=110)
        plt.close(fig)
        print(f"saved plot to {plot_file}")

    np.savez(
        args.filename,
        positions=data.samples["positions"],
        positions_raw=data.samples["positions_raw"],
        velocities=data.samples["velocities"],
        velocities_raw=data.samples["velocities_raw"],
        accelerations=data.samples["accelerations"],
        torques=data.samples["torques"],
        torques_raw=data.samples["torques_raw"],
        target_positions=out["Qsent"],
        target_velocities=out["QdotSent"],
        target_accelerations=out["QddotSent"],
        base_velocity=np.zeros((len(out["T"]), 6)),
        base_acceleration=np.zeros((len(out["T"]), 6)),
        base_rpy=np.zeros((len(out["T"]), 3)),
        contacts=np.array({}),
        times=data.samples["times"],
        frequency=np.float64(out["measured_frequency"]),
    )
    print(f"saved measurements to {args.filename}")


if __name__ == "__main__":
    main()
