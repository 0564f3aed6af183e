"""Figure of record of the JAX package for the against-JAX run of
chip_smoke.py's `cli_quick_start` phase.

Writes chip_smoke.py's numpy-made trajectory (`write_cli_trajectory`) with
the configuration CLI_JAX_OPTIONS over examples/configs/sevenlink_arm.yaml
and the arm's checked-in structural cache into a temporary directory, runs
the JAX package's root simulator.py and then identifier.py there on the CPU,
and prints CLI_JAX_N and CLI_JAX, the constants chip_smoke.py holds the
port's commands against on the card.  Run it as

    python tools/jax_cli_record.py
"""

import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def run_root(module, argv):
    """The root script `module`'s main() with `argv` as its arguments."""
    saved = sys.argv
    sys.argv = [module.__name__ + ".py", *argv]
    try:
        return module.main()
    finally:
        sys.argv = saved


def main():
    import numpy as np

    import chip_smoke
    import identifier
    import simulator
    from flobaroid_tpu.utils.helpers import is_physical_consistent

    tmp = tempfile.mkdtemp(prefix="flobaroid_cli_jax_")
    cwd = os.getcwd()
    try:
        urdf, cfg, traj = chip_smoke.cli_jax_workdir(tmp)
        d = os.path.dirname(urdf)
        os.chdir(d)  # the report's outputFilename is relative to the working directory
        meas = os.path.join(d, "measurements.npz")
        common = ["--config", cfg, "--model", urdf]
        run_root(simulator, [*common, "--trajectory", traj, "--filename", meas])
        idf = run_root(identifier, [*common, "--measurements", meas, "--validation", meas])
        m = idf.model
        record = dict(
            res_error_pct=float(idf.res_error),
            physically_consistent=bool(is_physical_consistent(
                idf._full_xstd()[: m.num_model_params], m.num_links)),
            sdp_status=idf.sdp.last_status, num_base_params=int(m.num_base_params),
            xBase=[float(v) for v in m.xBase])
        with np.load(traj) as f:
            print(f"CLI_JAX_N = {len(f['times'])}")
        print(f"CLI_JAX = {record!r}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
