"""Scale the inertial parameters of a URDF by a constant factor.

    python -m flobaroid_tpu_torch.tools.scaleInertia IN.urdf OUT.urdf \
        [--mass-scale S] [--inertia-scale S]

The port's copy of tools/scaleInertia.py (the reference's
tools/scaleInertia.py). Host work only."""

from __future__ import annotations

import argparse

from ..models.urdf import load_urdf, replace_params_in_urdf


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.tools.scaleInertia")
    p.add_argument("input_urdf")
    p.add_argument("output_urdf")
    p.add_argument("--mass-scale", type=float, default=1.0)
    p.add_argument("--inertia-scale", type=float, default=1.0)
    args = p.parse_args(argv)
    tree = load_urdf(args.input_urdf)
    pi = tree.std_params()
    for i in range(tree.num_links):
        pi[i * 10 : i * 10 + 4] *= args.mass_scale
        pi[i * 10 + 4 : i * 10 + 10] *= args.inertia_scale
    replace_params_in_urdf(args.input_urdf, args.output_urdf, pi, tree.link_names)
    print(f"wrote {args.output_urdf}")


if __name__ == "__main__":
    main()
