"""Simulate realistic measurements from a trajectory file.

    python -m flobaroid_tpu_torch.cli.simulator --config CFG --model URDF \
        [--trajectory traj.npz] [--filename meas.npz] [--device cpu]

Counterpart of the JAX package's root simulator.py main (reference
simulator.py:83-344): loads a trajectory npz, runs the effect chain of
`simulation/simulator.py::simulate_measurements` on the device and
writes a measurements npz with the reference's key contract. Default
paths are `<urdf>.trajectory.npz` and `<urdf>.measurements.npz`; an
existing measurements file is overwritten after a prompt, and only when
standard input is a terminal.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..utils.cli import base_parser, load_cli_config, setup_device


def main(argv=None):
    p = base_parser("Simulate realistic measurements from a trajectory file",
                    prog="python -m flobaroid_tpu_torch.cli.simulator")
    p.add_argument("--trajectory", help="trajectory npz file")
    p.add_argument("--filename", help="output measurements npz file")
    args = p.parse_args(argv)
    device = setup_device(args)
    config = load_cli_config(args)

    from ..models.urdf import load_urdf
    from ..simulation.simulator import (
        MEASUREMENT_KEYS,
        load_trajectory_data,
        simulate_measurements,
    )

    tree = load_urdf(config["urdf"])
    config.setdefault("num_dofs", tree.num_dofs)
    config.setdefault("jointNames", tree.dof_names)

    traj_file = args.trajectory or (config["urdf"] + ".trajectory.npz")
    out_file = args.filename or (config["urdf"] + ".measurements.npz")
    try:
        traj = load_trajectory_data(traj_file)
    except (FileNotFoundError, OSError):
        print(f"Trajectory file not found: {traj_file}")
        sys.exit(1)

    existing = {}
    if os.path.exists(out_file):
        with np.load(out_file, allow_pickle=True) as f:
            colliding = set(f.files) & MEASUREMENT_KEYS
            if colliding and sys.stdin.isatty():
                ans = input(f"{out_file} contains measurement data. Overwrite? [y/N] ")
                if ans.strip().lower() != "y":
                    print("Aborted.")
                    return
            existing = {k: f[k] for k in f.files}

    save_data = simulate_measurements(config, traj, existing=existing, device=device)
    np.savez(out_file, **save_data)
    print(f"Saved to {out_file}")


if __name__ == "__main__":
    main()
