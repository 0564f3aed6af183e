"""The port's slice end to end against the JAX package.

bench.py's headline flow (7-DOF arm, 2000 random states, simulated
torques, streamed Grams, OLS, physically consistent SDP, reporting) run
through flobaroid_tpu's Identification and flobaroid_tpu_torch's
(device="cpu", where the Gram wrapper runs its plain version), and its
option variants on 400 states. With
randomSamples=600 both read the checked-in structural cache, so both
use one projection (options without a cached structural Gram carry the
JAX projection over with convert.py). Also: the port loads neither JAX nor PyYAML, and its
config defaults equal the JAX package's.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import build_samples
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.utils import config as jax_config
from flobaroid_tpu.utils.helpers import is_physical_consistent
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.utils import config as torch_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
BENCH = dict(
    floatingBase=0, simulateTorques=1, useStructuralRegressor=1, randomSamples=600,
    estimateWith="std", materializeRegressor=0, constrainToConsistent=1,
    limitOverallMass=1, limitMassRange=1.0, limitMassToApriori=1,
    limitMassAprioriBoundary=0.3, verbose=0,
)


@pytest.fixture(scope="module")
def arm_copy(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline_arm")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz", ARM_URDF + ".gravity_regressor.npz"):
        shutil.copy(f, d)
    return str(d / "sevenlink_arm.urdf")


def _run(cls, urdf, reference=None, n=2000, **kw):
    """One bench pass on n samples; the port takes the JAX run's
    projection when given it (options without a checked-in cache compute
    their own)."""
    opt = jax_config.load_config(None, overrides={**BENCH, **kw})
    idf = cls(opt, urdf) if cls is JaxIdentification else cls(opt, urdf, device="cpu")
    if reference is not None:
        idf.model.load_state(state_from_jax_model(reference.model))
    idf.data.init_from_data(build_samples(urdf, n=n))
    idf.estimateParameters()
    return idf


def _base_err(idf):
    m = idf.model
    return float(np.linalg.norm(m.xBase - m.xBaseModel) / np.linalg.norm(m.xBaseModel))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _passes_bench_gates(idf):
    m = idf.model
    xf = idf._full_xstd()
    return (idf.res_error < 1.0 and _base_err(idf) < 0.05
            and is_physical_consistent(xf[: m.num_model_params], m.num_links)
            and idf.sdp.last_status == "optimal")


# The bench's own configuration at its 2000 samples; each option variant
# on 400 samples, enough to reach its branches in both packages.
VARIANTS = {
    "streamed": dict(n=2000),
    "materialized": dict(materializeRegressor=1, n=400),
    "wls": dict(useWLS=1, n=400),
    "friction": dict(identifyFrictionSimultaneously=1, n=400),
    "apriori": dict(useAPriori=1, n=400),
    "closest_to_cad": dict(identifyClosestToCAD=1, n=400),
    "observability": dict(cadRegularizationMode="observability", n=400),
    "std_direct": dict(estimateWith="std_direct", n=400),
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_slice_f64_matches_jax(arm_copy, variant):
    kw = dict(computeDtype="float64", **VARIANTS[variant])
    j = _run(JaxIdentification, arm_copy, **kw)
    t = _run(Identification, arm_copy, reference=j, **kw)
    assert t.model.num_base_params == j.model.num_base_params
    assert t.sdp.last_status == j.sdp.last_status == "optimal"
    assert _rel(t.model.xBase, j.model.xBase) <= 1e-8
    # xStd is unique only in its base directions (checked above at 1e-8);
    # the rest is set by the barrier at the SDP's last rung, where the JAX
    # solver itself moves by ~4e-5 under a 1e-13 change of its quadratic
    # (test_torch_sdp.py) and the two packages differ by up to ~7e-5
    assert _rel(t.model.xStd, j.model.xStd) <= 1e-3
    assert _passes_bench_gates(t) and _passes_bench_gates(j)
    assert set(t.stage_times) == set(j.stage_times)


@pytest.mark.timeout(120)
def test_slice_f32_passes_the_bench_gates(arm_copy):
    j = _run(JaxIdentification, arm_copy)
    t = _run(Identification, arm_copy)
    assert _passes_bench_gates(t) and _passes_bench_gates(j)
    assert _rel(t.model.xBase, j.model.xBase) <= 1e-3
    # warm second pass on the same object (the solver's warm start)
    t.data.init_from_data(build_samples(arm_copy))
    t.estimateParameters()
    assert _passes_bench_gates(t)


H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
WALK = dict(  # bench.py:90-98, the floating-base walking-contact identify
    floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0, limitMassToApriori=1,
    limitMassAprioriBoundary=0.5, cadRegularizationMode="observability",
    useStructuralRegressor=1, randomSamples=2000, materializeRegressor=0,
    estimateWith="std", verbose=0,
)
# the identify each case runs in the subprocess, after `idf` is built
_LOAD_SAMPLES = {
    "arm": """
rng = np.random.default_rng(0)
n, nd = 400, idf.model.num_dofs
idf.data.init_from_data(dict(positions=rng.uniform(-1, 1, (n, nd)),
    velocities=rng.standard_normal((n, nd)), accelerations=rng.standard_normal((n, nd)),
    torques=np.zeros((n, nd)), times=np.arange(n) / 200.0, frequency=np.array(200.0)))
""",
    "walking": """
from flobaroid_tpu_torch.simulation.scenarios import walking_contact_scenario
samples, _, _ = walking_contact_scenario(idf.model, N=900, seed=0, torque_noise=0.05,
                                         wrench_noise=0.5)
idf.data.init_from_data(samples)
""",
}


def _assert_port_loads_neither_jax_nor_yaml(tmp_path, case):
    """A CPU identify in a fresh process loads no jax, no yaml and no
    flobaroid_tpu module."""
    src, opt = (ARM_URDF, BENCH) if case == "arm" else (H30_URDF, WALK)
    urdf = tmp_path / os.path.basename(src)
    shutil.copy(src, urdf)
    shutil.copy(src + ".regressor.npz", str(urdf) + ".regressor.npz")
    code = f"""
import sys
import numpy as np
sys.path.insert(0, {REPO!r})
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.utils.config import load_config
opt = load_config(None, overrides={opt!r})
idf = Identification(opt, {str(urdf)!r}, device="cpu")
{_LOAD_SAMPLES[case]}
idf.estimateParameters()
assert idf.sdp.last_status.startswith("optimal"), idf.sdp.last_status
print("jax" in sys.modules, "yaml" in sys.modules,
      any(m == "flobaroid_tpu" or m.startswith("flobaroid_tpu.") for m in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # as the test processes: tier-1 runs 6 workers
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_port_loads_neither_jax_nor_yaml(tmp_path):
    _assert_port_loads_neither_jax_nor_yaml(tmp_path, "arm")


@pytest.mark.timeout(120)
def test_port_loads_neither_jax_nor_yaml_walking(tmp_path):
    """The same for the floating-base humanoid30 walking-contact identify
    (scenario generated by the port)."""
    _assert_port_loads_neither_jax_nor_yaml(tmp_path, "walking")


def test_config_defaults_equal_jax():
    assert torch_config.DEFAULTS == jax_config.DEFAULTS
    assert torch_config.OBSOLETE_REFERENCE_KEYS == jax_config.OBSOLETE_REFERENCE_KEYS
    opt = torch_config.load_config(None, overrides=dict(randomSamples=7))
    assert opt["randomSamples"] == 7 and opt["minTol"] == jax_config.DEFAULTS["minTol"]


def test_config_reads_yaml_file(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("randomSamples: 123\nfloatingBase: 0\n")
    assert torch_config.load_config(str(p)) == jax_config.load_config(str(p))


def test_unported_branches_raise(arm_copy, monkeypatch):
    with monkeypatch.context() as m:  # the default device is the card: no CPU fallback
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Identification(jax_config.load_config(None, overrides=BENCH), arm_copy)
    idf = Identification(jax_config.load_config(None, overrides={**BENCH, "useEssentialParams": 1}),
                         arm_copy, device="cpu")
    idf.data.init_from_data(build_samples(arm_copy, n=400))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idf.estimateParameters()


def test_data_preprocessing_matches_jax():
    """Data.preprocess with IMU processing (the port converts rotations
    with numpy where the JAX module used a vmap) and block selection."""
    from flobaroid_tpu.data import Data as JaxData
    from flobaroid_tpu_torch.data import Data

    rng = np.random.default_rng(3)
    n, nd = 600, 7
    s = {
        "positions": np.cumsum(rng.standard_normal((n, nd)) * 0.01, axis=0),
        "velocities": rng.standard_normal((n, nd)),
        "accelerations": rng.standard_normal((n, nd)),
        "torques": rng.standard_normal((n, nd)),
        "times": np.arange(n) / 200.0,
        "frequency": np.array(200.0),
        "IMUlinAcc": rng.standard_normal((n, 3)) * 0.1 + np.array([0.0, 0.0, 9.815]),
        "IMUrotVel": rng.standard_normal((n, 3)) * 0.1,
        "IMUrpy": np.cumsum(rng.standard_normal((n, 3)) * 0.01, axis=0),
    }
    opt = jax_config.load_config(None, overrides=dict(blockSize=100))
    out = []
    for D in (JaxData, Data):
        d = D(dict(opt))
        d.init_from_data({k: np.array(v) for k, v in s.items()})
        d.preprocess(imu=True)
        out.append(d)
    for k in ("positions", "velocities", "accelerations", "torques",
              "base_rpy", "base_velocity", "base_acceleration"):
        np.testing.assert_allclose(out[1].samples[k], out[0].samples[k], rtol=1e-12, atol=1e-12)
    conds = rng.random(6) * 100
    for d in out:
        d.select_blocks_from_stats(conds)
    assert out[1].selected_blocks == out[0].selected_blocks
    assert out[1].num_used_samples == out[0].num_used_samples


def test_data_files_blocks_and_standstill_match_jax(tmp_path):
    """Measurement files (two concatenated with startOffset), block
    selection through a score function, and the removal of standstill
    samples, through both packages' Data."""
    from flobaroid_tpu.data import Data as JaxData
    from flobaroid_tpu_torch.data import Data, save_measurements

    rng = np.random.default_rng(5)
    files = []
    for i, n in enumerate((260, 240)):
        v = rng.standard_normal((n, 7))
        v[::7] *= 1e-3  # standstill rows
        files.append(str(tmp_path / f"m{i}.npz"))
        save_measurements(files[-1], dict(
            positions=rng.standard_normal((n, 7)), velocities=v,
            accelerations=rng.standard_normal((n, 7)), torques=rng.standard_normal((n, 7)),
            times=np.arange(n) / 200.0, frequency=np.array(200.0)))
    opt = jax_config.load_config(None, overrides=dict(
        startOffset=10, blockSize=80, selectBestPerenctage=50, minVel=0.05))
    out = []
    for D in (JaxData, Data):
        d = D(dict(opt))
        d.init_from_files(files)
        d.select_blocks(lambda s: float(np.abs(s["torques"]).sum()))
        d.remove_near_zero_samples()
        out.append(d)
    j, t = out
    assert t.file_boundaries == j.file_boundaries
    assert t.selected_blocks == j.selected_blocks
    assert t.num_used_samples == j.num_used_samples < 240
    for k in ("positions", "velocities", "torques", "times"):
        np.testing.assert_array_equal(t.samples[k], j.samples[k])
