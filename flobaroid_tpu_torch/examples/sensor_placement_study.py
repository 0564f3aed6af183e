"""F/T sensor-placement identifiability study on the 30-DOF humanoid.

    python -m flobaroid_tpu_torch.examples.sensor_placement_study
        [--model URDF] [--samples 2000] [--device cpu]

The port's copy of examples/sensor_placement_study.py. It reproduces the
reference's sensor-budget analysis (reference
documentation/design_notes.md:98-110): a structural identifiability
analysis bounds what adding 6-axis F/T sensors can recover from the null
space — on the reference's walkman each added F/T recovered only ~3 of
~207 null directions, roughly additive for disjoint placements.

Model.structural_identifiability() gives the triple (individually
identifiable / base directions / null space), and
Model.sensor_placement_study() measures the structural rank gain of
candidate placements via the engine's subtree-wrench regressor rows. The
JAX example's `--cpu` (f64 on the CPU) is `--device cpu` here: on the
CPU the study computes in f64, on the card in f32.

The JAX package's figures (f64, 2000 random states): humanoid30 triple
83 / 220 / 120 of 340; foot F/T pair +20, wrist pair +6, all four +26.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from . import MODELS, copy_model


def run(model: str, samples: int = 2000, device="cuda") -> tuple[dict | None, dict | None]:
    """(structural identifiability triple, sensor placement study) of
    `model`, printed as the JAX example prints them; the study is None
    when the model has none of the default sensor links."""
    from ..device import resolve_device
    from ..model import Model
    from ..utils.config import load_config

    dev = resolve_device(device)
    o = load_config(None)
    o.update(dict(verbose=0, useStructuralRegressor=1, floatingBase=1,
                  identifyFrictionSimultaneously=1,
                  identifySymmetricVelFriction=1,
                  randomSamples=samples,
                  computeDtype="float64" if dev.type == "cpu" else "float32"))
    with tempfile.TemporaryDirectory(prefix="flobaroid_sensor_study_") as tmp:
        return _study(Model(o, copy_model(model, tmp), device=dev), samples)


def _study(m, samples: int):
    tri = m.structural_identifiability()
    print(f"triple: {tri['individually_identifiable']} individually "
          f"identifiable / {tri['base_directions']} base / "
          f"{tri['null_directions']} null of {tri['n_inertial_params']}")

    names = set(m.linkNames)
    sets = {}
    feet = [n for n in ("L_foot_ft", "R_foot_ft") if n in names]
    wrists = [n for n in ("LArm_7", "RArm_7") if n in names]
    if feet:
        sets["feet"] = feet
    if wrists:
        sets["wrists"] = wrists
    if feet and wrists:
        sets["feet+wrists"] = feet + wrists
    if not sets:
        print("no default sensor links found in this model; pass a "
              "humanoid30-style URDF or edit the candidate sets")
        return tri, None

    t0 = time.time()
    study = m.sensor_placement_study(sets, n_samples=samples)
    print(f"baseline inertial rank {study['baseline_rank']} "
          f"({study['null_directions']} null) [{time.time()-t0:.1f} s]")
    for k, v in study["sets"].items():
        print(f"  + {k} ({', '.join(v['links'])}): rank {v['rank']} "
              f"(gain +{v['gain']})")
    return tri, study


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        prog="python -m flobaroid_tpu_torch.examples.sensor_placement_study")
    ap.add_argument("--model", default=os.path.join(MODELS, "humanoid30.urdf"))
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the computation (default: cuda; cpu on request, in f64)")
    args = ap.parse_args(argv)
    run(args.model, args.samples, args.device)


if __name__ == "__main__":
    main()
