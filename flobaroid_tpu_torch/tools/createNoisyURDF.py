"""Create a perturbed copy of a URDF (for identification test models).

    python -m flobaroid_tpu_torch.tools.createNoisyURDF IN.urdf OUT.urdf \
        [--noise 0.1] [--seed 0]

The port's copy of tools/createNoisyURDF.py (the reference's
tools/createNoisyURDF.py): gaussian-perturb masses, COMs and inertias
while keeping each link physically consistent. Host work only."""

from __future__ import annotations

import argparse

import numpy as np

from ..models.urdf import load_urdf, replace_params_in_urdf
from ..utils.helpers import is_physical_consistent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.tools.createNoisyURDF")
    p.add_argument("input_urdf")
    p.add_argument("output_urdf")
    p.add_argument("--noise", type=float, default=0.1, help="relative std of perturbation")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    tree = load_urdf(args.input_urdf)
    pi = tree.std_params()
    rng = np.random.default_rng(args.seed)
    for _attempt in range(100):
        noisy = pi * (1.0 + args.noise * rng.standard_normal(pi.shape))
        # keep masses positive
        noisy[0::10] = np.abs(noisy[0::10])
        if is_physical_consistent(noisy, tree.num_links):
            break
    else:
        print("warning: could not find a consistent perturbation; writing last sample")
    replace_params_in_urdf(args.input_urdf, args.output_urdf, noisy, tree.link_names)
    rel = np.linalg.norm(noisy - pi) / np.linalg.norm(pi)
    print(f"wrote {args.output_urdf} (relative param distance {rel:.3f})")


if __name__ == "__main__":
    main()
