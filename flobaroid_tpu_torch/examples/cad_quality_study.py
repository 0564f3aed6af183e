"""CAD-regularization quality study on the suspended 30-DOF humanoid.

    python -m flobaroid_tpu_torch.examples.cad_quality_study [--generate]
        [--duration 40] [--noise 0.08] [--seed 0] [--device cpu]

The port's copy of examples/cad_quality_study.py. It reproduces the
reference's flagship estimation-quality result (reference
documentation/analysis_findings.md:45-68): the identified base-/std-
parameter L2 distance to the real model improves uniform > observability
> geometric ~= geometric+obs.

Default: the study runs from the checked-in artifacts
(examples/models/humanoid30_real.urdf and
examples/data/humanoid30_suspended_cad.npz). With --generate the port
rebuilds them first (`make_perturbed_real_urdf`, then
`generate_suspended_measurements` on the device), in a temporary
directory: the checked-in artifacts are never overwritten. Exit code 0
when the ordering is reproduced.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import MODELS, REPO, copy_model

CAD = os.path.join(MODELS, "humanoid30.urdf")
REAL = os.path.join(MODELS, "humanoid30_real.urdf")
MEAS = os.path.join(REPO, "examples", "data", "humanoid30_suspended_cad.npz")


def reproduced(res: dict) -> bool:
    """The reference's ordering of the base distances: uniform >
    observability > geometric (within 0.1 %), and geometric and
    geometric+obs within 15 % of each other."""
    base = {m: res[m]["base_dist"] for m in
            ("uniform", "observability", "geometric", "geometric_obs")}
    return bool(base["uniform"] > base["observability"] > base["geometric"] * 0.999
                and abs(base["geometric"] - base["geometric_obs"]) < 0.15 * base["geometric"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.examples.cad_quality_study")
    p.add_argument("--generate", action="store_true",
                   help="regenerate the real model + measurement artifacts")
    p.add_argument("--duration", type=float, default=40.0)
    p.add_argument("--noise", type=float, default=0.08)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the computation (default: cuda; cpu on request)")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..identification.cad_study import (
        format_table, generate_suspended_measurements, make_perturbed_real_urdf, run_cad_study)

    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="flobaroid_cad_study_")
    try:
        cad = copy_model(CAD, tmp)
        real = os.path.join(tmp, os.path.basename(REAL))
        meas = os.path.join(tmp, os.path.basename(MEAS))
        if args.generate:
            t0 = time.time()
            rel = make_perturbed_real_urdf(CAD, real, noise=args.noise, seed=args.seed)
            print(f"real model written (rel param dist {rel:.3f}, "
                  f"{time.time()-t0:.1f}s)", flush=True)
            t0 = time.time()
            m = generate_suspended_measurements(
                real, os.path.join(tmp, "m_full.npz"), duration=args.duration, freq=50.0,
                seed=args.seed, device=device)
            keep = {}
            for k, v in m.items():
                a = np.asarray(v)
                keep[k] = a.astype(np.float32) if a.dtype == np.float64 and a.ndim else a
            np.savez_compressed(meas, **keep)
            print(f"measurements written ({time.time()-t0:.1f}s, "
                  f"N={len(m['times'])})", flush=True)
        else:
            shutil.copy(REAL, real)
            shutil.copy(MEAS, meas)

        t0 = time.time()
        res = run_cad_study(cad, real, meas, verbose=True, device=device)
        print(f"\nstudy wall: {time.time()-t0:.1f}s")
        print(format_table(res))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = reproduced(res)
    print("reference ordering (uniform > observability > geometric ~= "
          f"geo+obs): {'REPRODUCED' if ok else 'NOT reproduced'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
