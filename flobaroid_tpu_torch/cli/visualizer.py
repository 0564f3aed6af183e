"""Visualize a robot model / trajectory / measurements file.

    python -m flobaroid_tpu_torch.cli.visualizer --config CFG --model URDF \
        [--trajectory file.npz [--webgl]] [--pose q1,q2,...] [--out FILE] [--device cpu]

Counterpart of the JAX package's root visualizer.py: a static pose
snapshot (PNG), a trajectory playback (animated HTML with a scrubber)
or the interactive WebGL viewer. Collision-model capsules and world
boxes are drawn, with violating pairs highlighted. The forward
kinematics and clearances of the whole trajectory run on the device in
one batched call each; the default device is the card, as for every
command of the port.
"""

from __future__ import annotations

import numpy as np

from ..utils.cli import base_parser, load_cli_config, setup_device


def main(argv=None):
    p = base_parser("Visualize robot model and trajectories",
                    prog="python -m flobaroid_tpu_torch.cli.visualizer")
    p.add_argument("--trajectory", help="trajectory/measurements npz to play back")
    p.add_argument("--world", help="world URDF with obstacles")
    p.add_argument("--out", default=None, help="output file (png or html)")
    p.add_argument("--pose", default=None,
                   help="comma-separated joint angles for a static snapshot")
    p.add_argument("--step", type=int, default=10, help="animation frame step")
    p.add_argument("--webgl", action="store_true",
                   help="interactive 3D WebGL viewer (orbit camera, "
                        "playback, collision highlighting) instead of "
                        "the PNG-frame scrubber")
    p.add_argument("--no_meshes", action="store_true",
                   help="skip visual STL meshes (wireframe capsules only)")
    p.add_argument("--margin", type=float, default=0.0,
                   help="extra clearance margin for collision highlighting")
    args = p.parse_args(argv)
    device = setup_device(args)
    config = load_cli_config(args)

    from ..collision import CollisionModel
    from ..dynamics.engine import DynamicsEngine
    from ..models.urdf import load_urdf
    from ..visualizer import Visualizer

    tree = load_urdf(config["urdf"])
    eng = DynamicsEngine(tree)
    world = load_urdf(args.world) if args.world else None
    cm = CollisionModel(tree, eng, config, world_tree=world)
    lims = tree.joint_limits()
    tau_limits = np.array([lims[j]["torque"] for j in tree.dof_names])
    viz = Visualizer(
        tree, eng, collision_model=cm,
        urdf_path=config["urdf"],
        mesh_base_dir=str(config.get("meshBaseDir", "meshes")),
        draw_meshes=not args.no_meshes,
        tau_limits=tau_limits, collision_margin=args.margin, device=device,
    )

    if args.trajectory:
        with np.load(args.trajectory, allow_pickle=True, encoding="latin1") as f:
            Q = f["positions"]
            base_rpy = f["base_rpy"] if "base_rpy" in f.files else None
            base_pos = f["base_position"] if "base_position" in f.files else None
            torques = f["torques"] if "torques" in f.files else None
        if args.webgl:
            from ..webgl_viewer import export_webgl

            out = args.out or "trajectory_3d.html"
            export_webgl(viz, Q, out, base_rpy=base_rpy, base_pos=base_pos,
                         step=args.step, torques=torques)
        else:
            out = args.out or "trajectory.html"
            viz.animate(Q, out, base_rpy=base_rpy, base_pos=base_pos,
                        step=args.step, torques=torques)
        print(f"wrote {out} ({len(Q)} samples)")
    else:
        q = (
            np.array([float(v) for v in args.pose.split(",")])
            if args.pose
            else np.zeros(tree.num_dofs)
        )
        out = args.out or "robot.png"
        viz.snapshot(q, out)
        n_viol = int(np.sum(viz.clearances(q[None])[0] < 0.0))
        print(f"wrote {out}; collisions at this pose: {n_viol}")


if __name__ == "__main__":
    main()
