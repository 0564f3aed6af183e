"""The port's slice end to end against the JAX package.

bench.py's headline flow (7-DOF arm, 2000 random states, simulated
torques, streamed Grams, OLS, physically consistent SDP, reporting) run
through flobaroid_tpu's Identification and flobaroid_tpu_torch's
(device="cpu", where the Gram wrapper runs its plain version), and its
option variants on 400 states. With
randomSamples=600 both read the checked-in structural cache, so both
use one projection (options without a cached structural Gram carry the
JAX projection over with convert.py). Also: the port loads neither JAX nor PyYAML, and its
config defaults equal the JAX package's. Essential parameters (the
deletion order decides the result, so the index sets must be equal), the
post-identification friction refit and the block scoring run on 800
noisy samples (numpy seed 5) through both packages.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import build_samples
from test_identification import synth_samples
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.utils import config as jax_config
from flobaroid_tpu.utils.helpers import is_physical_consistent
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.identification.identifier import Identification, score_blocks
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


# after the identify: the modules of the mesh tier, the posture optimizer,
# the Lagrangian oracle and the model analyses, each called once
_SLICE5 = """
import torch
from flobaroid_tpu_torch import collision_mesh, native_meshdist
from flobaroid_tpu_torch.dynamics import lagrangian
from flobaroid_tpu_torch.excitation import optimizer, posture
m = idf.model
q = torch.full((m.num_dofs,), 0.1, dtype=torch.float64)
pi = torch.as_tensor(m.xStdModel[: m.num_model_params])
assert torch.isfinite(lagrangian.inverse_dynamics_fixed(m.engine, pi, q, q, q)).all()
assert m.structural_identifiability()["base_directions"] > 0 and m.base_equations_str()
box = torch.as_tensor(collision_mesh.box_triangles((0, 0, 0), (0.5, 0.5, 0.5), np.eye(3))[0])
assert abs(float(collision_mesh.polytope_distance(box, box + 2.0)) - 3 ** 0.5) < 1e-6
assert torch.isfinite(posture.posture_objective(m, opt)(torch.ones((2, 5 * m.num_dofs)))).all()
"""


# then the console report, the timing utilities, the viewers and the TCP
# robot back-end, each called once (the report's text is kept off stdout)
_SLICE6 = """
import contextlib, io, socket, time
from flobaroid_tpu_torch import output, visualizer, webgl_viewer
from flobaroid_tpu_torch.robot_io import tcp_bridge
from flobaroid_tpu_torch.utils import timing
t0 = time.perf_counter()
with timing.stage_timer("report", dict(showTiming=0)), contextlib.redirect_stdout(io.StringIO()):
    text = output.OutputConsole(idf).render()
assert "torque estimation error" in text and time.perf_counter() > t0
viz = visualizer.Visualizer(m.tree, m.engine, draw_meshes=False, device="cpu")
assert np.all(np.isfinite(viz._link_world(np.zeros(m.num_dofs))[1]))
webgl_viewer.export_webgl(viz, np.zeros((3, m.num_dofs)), "viewer.html", step=1)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
try:
    tcp_bridge.ExcitationClient(port=port, timeout=2.0)
    raise AssertionError("a client connected where no server listens")
except ConnectionRefusedError:
    pass
"""


def _assert_port_loads_neither_jax_nor_yaml(tmp_path, case, **over):
    """A CPU identify in a fresh process, followed by one call into each
    module of the mesh tier, the posture optimizer, the Lagrangian oracle,
    the model analyses, the report, the timing utilities, the viewers and
    the TCP robot back-end, loads no jax, no yaml and no flobaroid_tpu
    module."""
    src, opt = (ARM_URDF, {**BENCH, **over}) if case == "arm" else (H30_URDF, WALK)
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
{_SLICE5}
{_SLICE6}
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


def test_port_loads_neither_jax_nor_yaml_geometric(tmp_path):
    """The same for a geometric (log-det SDP) identify with essential
    parameters' and the friction refit's modules on the path."""
    _assert_port_loads_neither_jax_nor_yaml(
        tmp_path, "arm", cadRegularizationMode="geometric", identifyFrictionSimultaneously=1,
        postIdentifyFriction=1)


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
    # no branch raises any more: sample sharding (bench's options with
    # shardSamples 2) identifies what the unsharded run identifies
    runs = {}
    for shards in (0, 2):
        idf = Identification(jax_config.load_config(None, overrides={
            **BENCH, "randomSamples": 600, "computeDtype": "float64", "gramChunk": 128,
            "shardSamples": shards}), arm_copy, device="cpu")
        idf.data.init_from_data(build_samples(arm_copy, n=400))
        idf.estimateParameters()
        runs[shards] = idf
    assert len(runs[2].model._staged["parts"]) == 8
    assert np.linalg.norm(runs[2].model.xBase - runs[0].model.xBase) <= 1e-10 * np.linalg.norm(
        runs[0].model.xBase)
    assert abs(runs[2].res_error - runs[0].res_error) <= 1e-8
    assert runs[2].sdp.last_status == runs[0].sdp.last_status
    # essential parameters no longer do (value parity: the tests below)
    idf = Identification(jax_config.load_config(None, overrides={**BENCH, "useEssentialParams": 1}),
                         arm_copy, device="cpu")
    idf.data.init_from_data(build_samples(arm_copy, n=400))
    idf.estimateParameters()
    assert "essential" in idf.stage_times and len(idf.baseEssentialIdx) > 0


def _noisy_pair(urdf, fric=None, **kw):
    """(JAX, port) identifies of 800 noisy samples of the arm (measured
    torques, not simulated ones), the port on the JAX projection."""
    samples, _ = synth_samples(urdf, n=800, noise=0.05, seed=5, fric=fric)
    opt = {**BENCH, "simulateTorques": 0, "computeDtype": "float64", **kw}
    j = JaxIdentification(jax_config.load_config(None, overrides=opt), urdf)
    t = Identification(jax_config.load_config(None, overrides=opt), urdf, device="cpu")
    t.model.load_state(state_from_jax_model(j.model))
    for idf in (j, t):
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
    return j, t


ESSENTIAL = {
    "streamed": dict(),
    "materialized": dict(materializeRegressor=1),
    "streamed_apriori": dict(useAPriori=1),
    "materialized_dependents": dict(materializeRegressor=1, useDependents=1),
    "base_essential": dict(estimateWith="base_essential"),
    "base_essential_materialized": dict(estimateWith="base_essential", materializeRegressor=1),
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("variant", list(ESSENTIAL))
def test_essential_parameters_match_jax(arm_copy, variant):
    """The same essential index set (the deletion order decides it), the
    same essential base vector, std essential columns and xStd, streamed
    (from the Grams and the device residual powers) and materialized;
    1e-8 relative (numpy on both sides, rounding order only)."""
    j, t = _noisy_pair(arm_copy, useEssentialParams=1, **ESSENTIAL[variant])
    assert t.baseEssentialIdx == j.baseEssentialIdx
    assert t.baseNonEssentialIdx == j.baseNonEssentialIdx
    assert 0 < t.num_essential_params == j.num_essential_params < t.model.num_base_params
    assert _rel(t.xBase_essential, j.xBase_essential) <= 1e-8
    assert np.array_equal(t.stdEssentialIdx, j.stdEssentialIdx)
    assert _rel(t.xStdEssential, j.xStdEssential) <= 1e-8
    assert _rel(t.p_sigma_x, j.p_sigma_x) <= 1e-6
    assert _rel(t.model.xStd, j.model.xStd) <= 1e-8
    assert _rel(t.model.xBase, j.model.xBase) <= 1e-8
    assert abs(t.res_error - j.res_error) <= 1e-8 * j.res_error
    assert set(t.stage_times) == set(j.stage_times) and "essential" in t.stage_times


FRICTION = {
    "streamed": dict(),
    "materialized": dict(materializeRegressor=1),
    "dead_zone_and_prior": dict(frictionSwerversDeadZone=0.5,
                                frictionFvRegularizationRelative=0.05),
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("variant", list(FRICTION))
def test_friction_refit_matches_jax(arm_copy, variant):
    """postIdentifyFriction: Fc / Fv / offset of the per-joint refit at
    1e-8 relative, Fv >= 0, and the write-back into xStd's friction
    slots."""
    fric = {"Fc": np.linspace(0.2, 0.5, 7), "Fv": np.linspace(0.05, 0.3, 7)}
    j, t = _noisy_pair(arm_copy, fric=fric, identifyFrictionSimultaneously=1,
                       identifySymmetricVelFriction=1, postIdentifyFriction=1, **FRICTION[variant])
    for k in ("Fc", "Fv", "off"):
        assert np.abs(t.postid_friction[k] - j.postid_friction[k]).max() <= 1e-8, k
    assert np.all(t.postid_friction["Fv"] >= 0)
    np.testing.assert_allclose(t.postid_friction["Fv"], fric["Fv"], atol=0.1)
    m, nd = t.model, t.model.num_dofs
    fs = m.friction_params_start
    assert np.array_equal(m.xStd[fs:fs + nd], t.postid_friction["Fc"])
    assert np.array_equal(m.xStd[fs + nd:fs + 2 * nd], t.postid_friction["Fv"])
    assert np.array_equal(m.xStd[fs + 2 * nd:fs + 3 * nd], t.postid_friction["off"])
    assert _rel(m.xStd[fs:], j.model.xStd[fs:]) <= 1e-8
    assert abs(t.res_error - j.res_error) <= 1e-6 * j.res_error


@pytest.mark.parametrize("fn", ["ols", "ols_contacts", "param_stddev", "wls_weights",
                                "std_essential", "std_essential_gram"])
def test_least_squares_primitives_match_jax(fn):
    """The port's copies of the least-squares primitives on random inputs
    (numpy on both sides: equal to rounding)."""
    from flobaroid_tpu.identification import least_squares as jls
    from flobaroid_tpu_torch.identification import least_squares as tls

    rng = np.random.default_rng(9)
    Y = rng.standard_normal((60, 8))
    x = rng.standard_normal(8)
    tau = Y @ x + 0.01 * rng.standard_normal(60)
    ess = np.where(np.arange(8) % 3 == 0, 0.0, rng.standard_normal(8))
    args = dict(
        ols=(Y, tau),
        ols_contacts=(Y, tau, 0.1 * rng.standard_normal(60)),
        param_stddev=(Y, x, tau.reshape(12, 5), (Y @ x).reshape(12, 5), 8),
        wls_weights=(np.abs(rng.standard_normal(5)) + 0.1, 12),
        std_essential=(Y, tau, ess, 5, x),
        std_essential_gram=(Y.T @ Y, Y.T @ tau, ess, 5, x),
    )[fn]
    name = fn.replace("_contacts", "")
    np.testing.assert_allclose(getattr(tls, name)(*args), getattr(jls, name)(*args), rtol=1e-12)
    if fn == "std_essential_gram":  # the Gram form equals the regressor form
        np.testing.assert_allclose(tls.std_essential_gram(*args),
                                   tls.std_essential(Y, tau, ess, 5, x), rtol=1e-8)


def _jax_cli_block_scoring(idf):
    """The scoring loop of the JAX package's identify CLI (the root
    identifier.py), on a JAX Identification."""
    m = idf.model
    m.computeRegressors(idf.data)
    rows_per = m.num_dofs + m.fb
    skip = int(idf.opt["skipSamples"]) + 1
    bs = int(idf.opt["blockSize"])
    conds, link_conds, grams = [], [], []
    for b in range(idf.data.num_blocks()):
        u0 = -(-(b * bs) // skip)
        u1 = -(-((b + 1) * bs) // skip)
        Yb = m.YBase[u0 * rows_per:min(u1 * rows_per, m.YBase.shape[0])]
        conds.append(float(np.linalg.cond(Yb)) if len(Yb) else 1e16)
        grams.append(Yb.T @ Yb)
        link_conds.append(m.getSubregressorsConditionNumbers(YBase=Yb))
    idf.data.select_blocks_from_stats(conds, link_conds, grams)
    return conds, link_conds


@pytest.mark.timeout(120)
@pytest.mark.parametrize("skip", [0, 2])
def test_block_scoring_matches_jax(arm_copy, skip):
    """score_blocks against the JAX CLI's loop: the same per-block and
    per-link condition numbers (1e-8) and the same selected blocks, also
    with skipSamples (block edges on used-sample indices); streamed
    regressors raise as in the CLI."""
    samples, _ = synth_samples(arm_copy, n=900, noise=0.05, seed=5)
    # a poorly excited stretch, so the blocks differ in quality
    samples["velocities"][300:500] *= 0.05
    samples["accelerations"][300:500] *= 0.05
    opt = {**BENCH, "simulateTorques": 0, "computeDtype": "float64", "materializeRegressor": 1,
           "blockSize": 100, "selectBestPerenctage": 50, "skipSamples": skip}
    j = JaxIdentification(jax_config.load_config(None, overrides=opt), arm_copy)
    t = Identification(jax_config.load_config(None, overrides=opt), arm_copy, device="cpu")
    t.model.load_state(state_from_jax_model(j.model))
    for idf in (j, t):
        idf.data.init_from_data(dict(samples))
    cj, lj = _jax_cli_block_scoring(j)
    ct, lt = score_blocks(t)
    assert len(ct) == len(cj) == 9
    assert _rel(ct, cj) <= 1e-8 and _rel(np.log(lt), np.log(lj)) <= 1e-8
    assert t.data.selected_blocks == j.data.selected_blocks
    assert 0 < len(t.data.selected_blocks) < 9
    streamed = Identification(
        jax_config.load_config(None, overrides={**opt, "materializeRegressor": 0}),
        arm_copy, device="cpu")
    streamed.data.init_from_data(dict(samples))
    with pytest.raises(ValueError, match="materializeRegressor=1"):
        score_blocks(streamed)


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
