"""The port's command-line pipeline (flobaroid_tpu_torch.cli) against the
JAX package's root scripts, on the CPU in f64.

One structural projection for both packages: the arm's URDF is copied
with its checked-in `sevenlink_arm.urdf.regressor.npz` and the options
that cache was made with (randomSamples 600, no friction columns), so
both read one Pb (the port draws its own structural states from a
torch.Generator, and a pivoted QR of another draw may pick other
columns). One numpy-made trajectory file (a multisine within the joint
limits, with `unobservable_params` to merge) feeds both simulators, and
the port's measurement file feeds both identifiers.

Tolerances: the simulator's saved arrays 1e-9 relative (the effect chain
and the noise draws are numpy's in both); the identifier's xBase and
validation error 1e-8, the written URDF's parameters 1e-3 (xStd is
unique only in base directions); `sample_final` and the trajectory
command's saved arrays 1e-10. Whole optimizer runs are not compared
across packages (an f32 AL stage turns rounding into different optima):
the trajectory commands are compared with one fixed optimizer result
given to both, and the port's own tiny-budget run must save the root's
keys with the root's shapes.
"""

import contextlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import identifier as jax_identifier
import simulator as jax_simulator
import trajectory as jax_trajectory
from flobaroid_tpu.excitation import optimizer as jopt
from flobaroid_tpu.excitation import trajectory as jtraj
from flobaroid_tpu.model import Model as JaxModel
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.cli import excite as cli_excite
from flobaroid_tpu_torch.cli import identifier as cli_identifier
from flobaroid_tpu_torch.cli import simulator as cli_simulator
from flobaroid_tpu_torch.cli import trajectory as cli_trajectory
from flobaroid_tpu_torch.cli import visualizer as cli_visualizer
from flobaroid_tpu_torch.excitation import optimizer as topt
from flobaroid_tpu_torch.excitation import trajectory as ttraj
from flobaroid_tpu_torch.model import Model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
ARM_CONFIG = os.path.join(REPO, "examples", "configs", "sevenlink_arm.yaml")
# the example configuration on the checked-in structural cache, in f64,
# with friction neither simulated nor identified
OVERRIDES = dict(randomSamples=600, identifyFrictionSimultaneously=0, simulateFriction=0,
                 computeDtype="float64", verbose=0, createPlots=0)
UNOBSERVABLE = [14, 17]  # pinned to a priori through the trajectory file


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def multisine_trajectory(urdf, n=300, freq=100.0, seed=0):
    """Positions, velocities and accelerations of a multisine within the
    joint limits (numpy seed), in the trajectory command's key layout."""
    tree = jax_load_urdf(urdf)
    lims = tree.joint_limits()
    lo = np.array([lims[j]["lower"] for j in tree.dof_names])
    hi = np.array([lims[j]["upper"] for j in tree.dof_names])
    rng = np.random.default_rng(seed)
    nd = tree.num_dofs
    t = np.arange(n) / freq
    w = rng.uniform(1.0, 4.0, nd)
    ph = rng.uniform(0, 2 * np.pi, nd)
    amp = 0.4 * (hi - lo) / 2
    mid = (hi + lo) / 2
    arg = w * t[:, None] + ph
    return dict(static=False, positions=mid + amp * np.sin(arg), velocities=amp * w * np.cos(arg),
                accelerations=-amp * w**2 * np.sin(arg), times=t, frequency=np.float64(freq),
                unobservable_params=np.asarray(UNOBSERVABLE, dtype=np.int64))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    shutil.copy(ARM_URDF, d)
    shutil.copy(ARM_URDF + ".regressor.npz", d)
    urdf = str(d / "sevenlink_arm.urdf")
    with open(ARM_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.update(OVERRIDES, outputFilename=str(d / "report.html"))
    cfg_file = str(d / "cfg.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(cfg, f)
    traj = str(d / "traj.npz")
    np.savez(traj, **multisine_trajectory(urdf))
    return dict(dir=d, urdf=urdf, cfg=cfg_file, traj=traj)


def _run_root(main, argv, cwd):
    """A root script's main() with sys.argv set, in `cwd`; returns
    (result, stdout)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [main.__module__ + ".py", *argv])
        mp.chdir(cwd)
        with contextlib.redirect_stdout(out):
            res = main()
    return res, out.getvalue()


def _run_port(main, argv, cwd):
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        with contextlib.redirect_stdout(out):
            res = main([*argv, "--device", "cpu"])
    return res, out.getvalue()


def _common(work):
    return ["--config", work["cfg"], "--model", work["urdf"]]


# ----------------------------------------------------------------------
# simulator
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def measurements(work):
    d = work["dir"]
    files = {}
    for name, run, main in (("jax", _run_root, jax_simulator.main),
                            ("port", _run_port, cli_simulator.main)):
        files[name] = str(d / f"meas_{name}.npz")
        run(main, [*_common(work), "--trajectory", work["traj"], "--filename", files[name]], d)
    return files


def test_simulator_matches_root(measurements):
    """Every saved array within 1e-9 relative, the same keys."""
    with np.load(measurements["jax"], allow_pickle=True) as fj, \
            np.load(measurements["port"], allow_pickle=True) as fp:
        assert set(fj.files) == set(fp.files)
        for k in fj.files:
            a, b = fp[k], fj[k]
            if a.dtype == object:
                assert a.item() == b.item(), k
                continue
            assert a.shape == b.shape, k
            assert _rel(a, b) <= 1e-9 or np.abs(b).max() == 0 == np.abs(a).max(), k


# ----------------------------------------------------------------------
# identifier
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def identified(work, measurements):
    d = work["dir"]
    meas = measurements["port"]
    out = {}
    for name, run, main in (("jax", _run_root, jax_identifier.main),
                            ("port", _run_port, cli_identifier.main)):
        urdf_out = str(d / f"identified_{name}.urdf")
        idf, text = run(main, [*_common(work), "--measurements", meas, "--validation", meas,
                               "--model_real", ARM_URDF, "--model_output", urdf_out,
                               "--trajectory", work["traj"]], d)
        out[name] = dict(idf=idf, text=text, urdf=urdf_out)
    return out


def test_identifier_matches_root(identified):
    """xBase 1e-8, validation error 1e-8, the same consistency verdict,
    the unobservable params pinned in both, the written URDF's params 1e-3."""
    j, p = identified["jax"], identified["port"]
    mj, mp = j["idf"].model, p["idf"].model
    assert mp.num_base_params == mj.num_base_params
    assert _rel(mp.xBase, mj.xBase) <= 1e-8
    assert abs(p["idf"].val_error - j["idf"].val_error) <= 1e-8 * max(1.0, j["idf"].val_error)
    assert p["idf"].opt["dontChangeParams"] == j["idf"].opt["dontChangeParams"]
    assert set(UNOBSERVABLE) <= set(p["idf"].opt["dontChangeParams"])
    for text in (j["text"], p["text"]):
        assert "torque estimation error" in text and "validation:" in text
        assert "pinning 2 unobservable params to a priori" in text
    verdict = ["all links physically consistent" in t["text"] for t in (j, p)]
    assert verdict[0] == verdict[1]
    written = [os.path.exists(t["urdf"]) for t in (j, p)]
    assert written[0] == written[1] == verdict[0]
    if written[0]:
        pj = jax_load_urdf(j["urdf"]).std_params()
        pp = jax_load_urdf(p["urdf"]).std_params()
        assert _rel(pp, pj) <= 1e-3


# ----------------------------------------------------------------------
# trajectory
# ----------------------------------------------------------------------
def _arm_config(**over):
    return load_config(ARM_CONFIG, overrides={**OVERRIDES, **over})


def _fixed_x(spec_nf, nd, seed=3):
    rng = np.random.default_rng(seed)
    tot = sum(spec_nf)
    return np.concatenate([[1.3], rng.uniform(-0.2, 0.2, nd),
                           rng.uniform(-0.4, 0.4, tot), rng.uniform(-0.4, 0.4, tot)])


@pytest.fixture(scope="module")
def models(work):
    cfg = _arm_config(observabilityThreshold=0.02)
    jm = JaxModel(dict(cfg), work["urdf"])
    tm = Model(dict(cfg), work["urdf"], device="cpu")
    assert np.array_equal(tm.Pb, np.asarray(jm.Pb))
    return cfg, jm, tm


def test_sample_final_and_observability_match_root(models):
    """sample_final at 1e-10; the same unobservable params (a threshold
    at which some base directions of one short period are unobservable)."""
    cfg, jm, tm = models
    nf = (2, 1, 3, 2, 1, 2, 2)
    lims = tm.limits
    limits = tuple((float(lims[j]["lower"]), float(lims[j]["upper"])) for j in tm.jointNames)
    x = _fixed_x(nf, tm.num_dofs)
    rj = jax_trajectory.sample_final(jtraj.FourierSpec(nf=nf, limits=limits), x, cfg)
    rp = cli_trajectory.sample_final(ttraj.FourierSpec(nf=nf, limits=limits), x, cfg)
    for a, b in zip(rp, rj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    times, Q, V, A = rp
    oj = jax_trajectory.observability(jm, Q, V, A, times, cfg)
    op = cli_trajectory.observability(tm, Q, V, A, times, cfg)
    assert op == oj
    assert len(op[0]) > 0 and op[2] < tm.num_base_params


def _saved(path):
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(a, b, atol):
    assert set(a) == set(b)
    for k in b:
        if b[k].dtype == object:
            assert len(a[k]) == len(b[k]), k
            for u, v in zip(a[k], b[k]):
                np.testing.assert_allclose(np.asarray(u, float), np.asarray(v, float),
                                           rtol=0, atol=atol, err_msg=k)
        else:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def test_static_posture_branch_matches_root(work, tmp_path):
    """The config's staticPostures played back by both commands: the same
    saved arrays at 1e-10."""
    cfg = _arm_config(staticPostures=[[0.1 * k] * 7 for k in (1, -2, 3)])
    cfg_file = tmp_path / "static.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if v is not None}, f)
    common = ["--config", str(cfg_file), "--model", work["urdf"]]
    _run_root(jax_trajectory.main, [*common, "--filename", str(tmp_path / "j.npz")], tmp_path)
    _run_port(cli_trajectory.main, [*common, "--filename", str(tmp_path / "p.npz")], tmp_path)
    j, p = _saved(tmp_path / "j.npz"), _saved(tmp_path / "p.npz")
    assert bool(p["static"]) and len(p["angles"]) == 3
    _assert_same_npz(p, j, 1e-10)


@pytest.fixture(scope="module")
def root_fourier_file(work, tmp_path_factory):
    """The root trajectory command with its optimizer's result fixed
    (everything after the optimization runs: sampling, transitions,
    observability, the saved keys)."""
    d = tmp_path_factory.mktemp("torch_cli_traj")
    nf = (4,) * 7
    tree = jax_load_urdf(work["urdf"])
    lims = tree.joint_limits()
    limits = tuple((float(lims[j]["lower"]), float(lims[j]["upper"])) for j in tree.dof_names)
    x = _fixed_x(nf, tree.num_dofs)
    info = dict(f=1.0, feasible=True, n_observable=0, max_violation=-1.0)
    files = {}
    for name, run, main, mod, spec in (
            ("jax", _run_root, jax_trajectory.main, jopt, jtraj.FourierSpec(nf=nf, limits=limits)),
            ("port", _run_port, cli_trajectory.main, topt,
             ttraj.FourierSpec(nf=nf, limits=limits))):
        files[name] = str(d / f"{name}.npz")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "optimize_trajectory", lambda *a, _s=spec, **k: (x, _s, None, info))
            run(main, [*_common(work), "--filename", files[name]], d)
    return files


def test_fourier_branch_matches_root(root_fourier_file):
    """Given one optimizer result, both commands save the same arrays
    (1e-10): the sampled period with its min-jerk transitions, the
    coefficients, the limits and the observability keys."""
    j, p = _saved(root_fourier_file["jax"]), _saved(root_fourier_file["port"])
    for k in ("a", "b"):  # ragged coefficient lists
        assert len(p[k]) == len(j[k]) == 7
    _assert_same_npz(p, j, 1e-10)


def test_port_fourier_run_saves_root_keys(work, root_fourier_file, tmp_path):
    """A tiny-budget optimization by the port saves the root's keys with
    the root's shapes (the period's length follows the optimized pulsation;
    a short period and no collision constraints keep the run small)."""
    cfg = _arm_config(globalOptSize=4, globalOptIterations=1, localOptIterations=1,
                      localOptStages=1, checkCollisions=0, trajectoryPulseMin=2.0,
                      trajectoryPulseMax=2.5, trajectoryPulseInit=2.2, transitionDuration=0.5)
    cfg_file = tmp_path / "tiny.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if v is not None}, f)
    _, text = _run_port(cli_trajectory.main, ["--config", str(cfg_file), "--model", work["urdf"],
                                              "--filename", str(tmp_path / "p.npz")], tmp_path)
    assert "feasible=" in text and "Observability:" in text
    j, p = _saved(root_fourier_file["jax"]), _saved(tmp_path / "p.npz")
    assert set(p) == set(j)
    for k in j:
        if k in ("positions", "velocities", "accelerations", "times", "unobservable_params"):
            assert p[k].ndim == j[k].ndim and p[k].shape[1:] == j[k].shape[1:], k
        else:
            assert p[k].shape == j[k].shape and p[k].dtype.kind == j[k].dtype.kind, k
    assert np.all(np.isfinite(p["positions"]))


# ----------------------------------------------------------------------
# the commands' rules: no JAX, the card by default
# ----------------------------------------------------------------------
def test_identifier_command_loads_neither_jax_nor_jax_package(work, measurements, tmp_path):
    """`python -m flobaroid_tpu_torch.cli.identifier --device cpu` in a
    fresh process, then the sharded dry run on two CPU shards and every
    module of tools/ and examples/: the run's modules include no jax and
    no flobaroid_tpu."""
    argv = [*_common(work), "--measurements", measurements["port"], "--device", "cpu"]
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import runpy
sys.argv = ["identifier"] + {argv!r}
runpy.run_module("flobaroid_tpu_torch.cli.identifier", run_name="__main__")
from flobaroid_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(2, device="cpu")
for name in ("csv2npz", "getMaxInertia", "createNoisyURDF", "scaleInertia", "paramErrorPlot"):
    __import__("flobaroid_tpu_torch.tools." + name)
for name in ("cad_quality_study", "sensor_placement_study", "walkman_full_flow"):
    __import__("flobaroid_tpu_torch.examples." + name)
print("jax" in sys.modules,
      any(m == "flobaroid_tpu" or m.startswith("flobaroid_tpu.") for m in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "torque estimation error" in out.stdout
    assert out.stdout.split()[-2:] == ["False", "False"]


@pytest.mark.parametrize("name", ["trajectory", "simulator", "identifier", "visualizer"])
def test_commands_default_to_the_card(name, work, measurements, tmp_path):
    """Without --device each command that computes on a device asks for
    the card, and on a host without one it raises before any work;
    nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    main = dict(trajectory=cli_trajectory, simulator=cli_simulator, identifier=cli_identifier,
                visualizer=cli_visualizer)[name].main
    extra = dict(trajectory=["--filename", str(tmp_path / "t.npz")],
                 simulator=["--trajectory", work["traj"], "--filename", str(tmp_path / "m.npz")],
                 identifier=["--measurements", measurements["port"]],
                 visualizer=["--out", str(tmp_path / "r.png")])[name]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main([*_common(work), *extra])
    assert os.listdir(tmp_path) == []


def test_excite_is_host_work(work, capsys):
    """excite computes nothing on a device: it has no --device and runs
    on a host without a card."""
    cli_excite.main([*_common(work), "--trajectory", work["traj"], "--dryrun"])
    assert "dryrun: trajectory loaded OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_excite.main([*_common(work), "--trajectory", work["traj"], "--dryrun",
                         "--device", "cpu"])


@pytest.mark.slow
@pytest.mark.timeout(420)
def test_full_cli_pipeline_port(tmp_path):
    """trajectory -> simulator -> identifier -> visualizer through the
    port's commands on the CPU, at tests/test_cli_e2e.py's budget."""
    cfg = dict(
        excitationFrequency=50.0, floatingBase=0, verbose=0, trajectoryPulseMin=1.0,
        trajectoryPulseMax=2.0, trajectoryDefaultNf=3, globalOptSize=10, globalOptIterations=3,
        localOptIterations=2, useStructuralRegressor=1, randomSamples=800,
        transitionDuration=1.0, identifyFrictionSimultaneously=1,
        identifySymmetricVelFriction=1, constrainToConsistent=1, limitOverallMass=1,
        limitMassRange=1.0, limitMassToApriori=1, limitMassAprioriBoundary=0.5,
        simulateCableForces=0, simulateGravityCompResidual=0, simulateThermalDrift=0,
        simulateTimingJitter=0, createPlots=int(importlib.util.find_spec("matplotlib") is not None),
        outputFilename=str(tmp_path / "report.html"), estimateWith="std")
    cfg_file = tmp_path / "cfg.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(cfg, f)
    shutil.copy(ARM_URDF, tmp_path)
    urdf = str(tmp_path / "sevenlink_arm.urdf")
    common = ["--config", str(cfg_file), "--model", urdf]
    traj, meas, out_urdf = (str(tmp_path / n) for n in ("traj.npz", "meas.npz", "id.urdf"))
    _run_port(cli_trajectory.main, [*common, "--filename", traj], tmp_path)
    _run_port(cli_simulator.main, [*common, "--trajectory", traj, "--filename", meas], tmp_path)
    _, out = _run_port(cli_identifier.main, [
        *common, "--measurements", meas, "--validation", meas, "--model_real", ARM_URDF,
        "--model_output", out_urdf, "--trajectory", traj], tmp_path)
    assert "torque estimation error" in out and "physically consistent" in out
    assert "validation:" in out and os.path.exists(out_urdf)
    m_id = jax_load_urdf(out_urdf).std_params()[0::10]
    m_true = jax_load_urdf(ARM_URDF).std_params()[0::10]
    nz = m_true > 0
    assert np.all(np.abs(m_id[nz] - m_true[nz]) / m_true[nz] < 0.5)
    _run_port(cli_visualizer.main, [*common, "--trajectory", meas, "--webgl",
                                    "--out", str(tmp_path / "v.html")], tmp_path)
    assert os.path.getsize(tmp_path / "v.html") > 1000
