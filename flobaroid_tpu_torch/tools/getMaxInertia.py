"""Maximum apparent inertia per joint over random configurations.

    python -m flobaroid_tpu_torch.tools.getMaxInertia URDF [--samples 200] \
        [--device cpu]

The port's copy of tools/getMaxInertia.py (the reference's
tools/getMaxInertia.py; useful for controller gain tuning): the joint-
space mass matrices of all the random configurations in one batch on the
device (f32 on the card, f64 on the CPU). The JAX tool pins itself to the
CPU; this one runs on the card unless `--device cpu` is given."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..dynamics.engine import DynamicsEngine
from ..models.urdf import load_urdf


def max_inertia_diagonals(urdf: str, samples: int = 200, device="cuda") -> tuple[list, np.ndarray]:
    """(joint names, diag M(q) (samples, n)) over `samples` random
    in-limit configurations drawn from numpy seed 0 (the JAX tool's)."""
    dev = resolve_device(device)
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    tree = load_urdf(urdf)
    eng = DynamicsEngine(tree)
    lims = tree.joint_limits()
    lo = np.array([lims[j]["lower"] for j in tree.dof_names])
    hi = np.array([lims[j]["upper"] for j in tree.dof_names])
    lo = np.where(np.isfinite(lo), lo, -np.pi)
    hi = np.where(np.isfinite(hi), hi, np.pi)
    rng = np.random.default_rng(0)
    Q = lo + (hi - lo) * rng.random((samples, tree.num_dofs))
    pi = torch.as_tensor(tree.std_params(), dtype=dtype, device=dev)
    M = eng.mass_matrix(pi, torch.as_tensor(Q, dtype=dtype, device=dev), floating=False)
    return list(tree.dof_names), torch.diagonal(M, dim1=1, dim2=2).double().cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.tools.getMaxInertia")
    p.add_argument("urdf")
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="torch device of the computation (default: cuda; cpu on request)")
    args = p.parse_args(argv)
    names, diag = max_inertia_diagonals(args.urdf, args.samples, args.device)
    for j, name in enumerate(names):
        print(f"{name}: max apparent inertia {diag[:, j].max():.4f} kg m^2 "
              f"(min {diag[:, j].min():.4f})")


if __name__ == "__main__":
    main()
