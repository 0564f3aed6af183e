"""The port's tools (`flobaroid_tpu_torch.tools`) through `main(argv)`
against the JAX package's tools on the same inputs, CPU.

The JAX tools run in this process with `sys.argv` set (their `main()`
reads it). Held: createNoisyURDF and scaleInertia write byte-equal URDFs
for one seed and one scale; csv2npz writes equal arrays (1e-12) without
resimulation, and with `--resimulate-torques` torques within 1e-4 of
max|tau| of the JAX tool's (both simulate in f32, the configuration's
computeDtype); getMaxInertia prints the JAX tool's lines (both in f64
here) and its diagonals lie within 1e-5 relative of the JAX engine's;
paramErrorPlot prints the JAX tool's error and writes its plot.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from flobaroid_tpu_torch.tools import (
    createNoisyURDF, csv2npz, getMaxInertia, paramErrorPlot, scaleInertia)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return jax_tool(name).main()


@pytest.mark.parametrize("seed", [0, 3])
def test_create_noisy_urdf_writes_the_jax_tools_bytes(tmp_path, monkeypatch, capsys, seed):
    jout, tout = tmp_path / "j.urdf", tmp_path / "t.urdf"
    run_jax("createNoisyURDF", [ARM_URDF, str(jout), "--seed", str(seed)], monkeypatch)
    jtext = capsys.readouterr().out
    createNoisyURDF.main([ARM_URDF, str(tout), "--seed", str(seed)])
    ttext = capsys.readouterr().out
    assert tout.read_bytes() == jout.read_bytes()
    assert ttext.replace("t.urdf", "j.urdf") == jtext


def test_scale_inertia_writes_the_jax_tools_bytes(tmp_path, monkeypatch):
    jout, tout = tmp_path / "j.urdf", tmp_path / "t.urdf"
    args = ["--mass-scale", "1.5", "--inertia-scale", "0.75"]
    run_jax("scaleInertia", [ARM_URDF, str(jout), *args], monkeypatch)
    scaleInertia.main([ARM_URDF, str(tout), *args])
    assert tout.read_bytes() == jout.read_bytes() != open(ARM_URDF, "rb").read()


@pytest.fixture(scope="module")
def csv_log(tmp_path_factory):
    """A CSV of 300 states (time, 7 positions, 7 junk torques) at 200 Hz
    and the configuration the tools read."""
    d = tmp_path_factory.mktemp("torch_tools_csv")
    rng = np.random.default_rng(0)
    n, nd = 300, 7
    t = np.arange(n) / 200.0
    q = 0.6 * np.sin(2 * np.pi * 0.7 * t[:, None] + np.arange(nd)) + 0.05 * rng.standard_normal(nd)
    cols = np.hstack([t[:, None], q, rng.standard_normal((n, nd)) * 50.0])
    f = d / "log.csv"
    np.savetxt(f, cols, delimiter=",")
    cfg = d / "cfg.yaml"
    with open(cfg, "w") as fh:
        yaml.safe_dump(dict(floatingBase=0, verbose=0, excitationFrequency=200.0), fh)
    return f, cfg


@pytest.mark.timeout(120)
@pytest.mark.parametrize("resimulate", [False, True], ids=["convert", "resimulate"])
def test_csv2npz_matches_the_jax_tool(csv_log, tmp_path, monkeypatch, resimulate):
    f, cfg = csv_log
    common = ["--config", str(cfg), "--model", ARM_URDF, "--csv", str(f), "--time-col", "0",
              "--pos-cols", "1:8", "--tau-cols", "8:15", "--joint-order=1,0,2,3,4,5,6",
              "--joint-signs=-1,1,1,1,1,1,1"]
    if resimulate:
        common.append("--resimulate-torques")
    jout, tout = tmp_path / "j.npz", tmp_path / "t.npz"
    assert run_jax("csv2npz", [*common, "--out", str(jout)], monkeypatch) == 0
    assert csv2npz.main([*common, "--out", str(tout), "--device", "cpu"]) == 0
    j, t = np.load(jout), np.load(tout)
    assert set(t.files) == set(j.files)
    for k in j.files:
        a, b = t[k], j[k]
        assert a.shape == b.shape, k
        if resimulate and k in ("torques", "torques_raw"):
            # both simulate in f32 (the configuration's computeDtype)
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.timeout(120)
def test_get_max_inertia_matches_the_jax_tool(monkeypatch, capsys):
    import jax
    import jax.numpy as jnp

    from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
    from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf

    run_jax("getMaxInertia", [ARM_URDF, "--samples", "50"], monkeypatch)
    jtext = capsys.readouterr().out
    getMaxInertia.main([ARM_URDF, "--samples", "50", "--device", "cpu"])
    assert capsys.readouterr().out == jtext and jtext.count("max apparent inertia") == 7
    names, diag = getMaxInertia.max_inertia_diagonals(ARM_URDF, 50, device="cpu")
    tree = jax_load_urdf(ARM_URDF)
    eng = JaxEngine(tree)
    lims = tree.joint_limits()
    lo = np.array([lims[j]["lower"] for j in tree.dof_names])
    hi = np.array([lims[j]["upper"] for j in tree.dof_names])
    Q = lo + (hi - lo) * np.random.default_rng(0).random((50, tree.num_dofs))
    pi = jnp.asarray(tree.std_params())
    M = jax.vmap(lambda q: eng.mass_matrix(pi, q, floating=False))(jnp.asarray(Q))
    want = np.asarray(jnp.diagonal(M, axis1=1, axis2=2))
    assert names == list(tree.dof_names)
    assert np.abs(diag - want).max() <= 1e-5 * np.abs(want).max()


def test_param_error_plot_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    noisy = tmp_path / "noisy.urdf"
    createNoisyURDF.main([ARM_URDF, str(noisy), "--seed", "1"])
    capsys.readouterr()
    jpng, tpng = tmp_path / "j.png", tmp_path / "t.png"
    run_jax("paramErrorPlot", [str(noisy), ARM_URDF, "--out", str(jpng)], monkeypatch)
    jtext = capsys.readouterr().out
    paramErrorPlot.main([str(noisy), ARM_URDF, "--out", str(tpng)])
    ttext = capsys.readouterr().out
    assert ttext.replace("t.png", "j.png") == jtext and "relative L2 error" in ttext
    assert tpng.stat().st_size > 1000
