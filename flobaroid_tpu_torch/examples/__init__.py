"""Examples of the port, one module per example of the JAX package's
`examples/` whose inputs are in the repository (cad_quality_study,
sensor_placement_study, walkman_full_flow) and `identify_sevenlink.sh`,
the README's quick start through the port's commands. Each module has
`main(argv=None)`, runs as `python -m flobaroid_tpu_torch.examples.<name>`
and computes on `--device` (default `cuda`). The examples work on copies
of the repository's models in a temporary directory, so no cache is
written beside them."""

from __future__ import annotations

import glob
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODELS = os.path.join(REPO, "examples", "models")


def copy_model(urdf: str, dst_dir: str) -> str:
    """Copy `urdf` and the structural caches beside it into dst_dir;
    returns the copy's path."""
    os.makedirs(dst_dir, exist_ok=True)
    for f in [urdf, *glob.glob(glob.escape(urdf) + ".*regressor.npz")]:
        shutil.copy(f, dst_dir)
    return os.path.join(dst_dir, os.path.basename(urdf))
