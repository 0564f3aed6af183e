"""The port's examples (`flobaroid_tpu_torch.examples`) on the CPU.

Held: the sensor-placement study on the 7-DOF arm prints the JAX
example's lines (the structural triple; the arm has none of the default
sensor links); the walkman flow's simulate and identify stages at
tests/test_walkman_flow.py's CI size (the same multi-sine excitation,
1928 samples, 2/3 for training) meet that test's gates; the CAD study's
verdict follows the JAX example's rule, and the example reproduces the
reference's ordering from the checked-in artifacts.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from flobaroid_tpu_torch.examples import cad_quality_study, sensor_placement_study
from flobaroid_tpu_torch.examples import walkman_full_flow as flow

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")


@pytest.mark.timeout(120)
def test_sensor_placement_study_prints_the_jax_examples_lines(tmp_path, monkeypatch, capsys):
    urdf = tmp_path / "arm.urdf"
    shutil.copy(ARM_URDF, urdf)
    monkeypatch.chdir(REPO)  # the JAX example changes to the repository root on import
    spec = importlib.util.spec_from_file_location(
        "jax_sensor_placement_study", os.path.join(REPO, "examples", "sensor_placement_study.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    monkeypatch.setattr(sys, "argv", ["sensor_placement_study", "--model", str(urdf),
                                      "--samples", "500", "--cpu"])
    jax_example.main()
    jtext = capsys.readouterr().out
    sensor_placement_study.main(["--model", ARM_URDF, "--samples", "500", "--device", "cpu"])
    ttext = capsys.readouterr().out
    assert ttext == jtext and "no default sensor links" in ttext
    tri, study = sensor_placement_study.run(ARM_URDF, 500, device="cpu")
    assert study is None and tri["base_directions"] + tri["null_directions"] == 80


@pytest.fixture(scope="module")
def walkman_data(tmp_path_factory):
    """tests/test_walkman_flow.py's excitation (the optimizer's harmonic
    taper from numpy seed 3, pulsation 1.3, 8 periods at 50 Hz) through
    the flow's simulate stage, split 2/3 train, 1/3 held out."""
    from flobaroid_tpu_torch.excitation.optimizer import initial_candidate
    from flobaroid_tpu_torch.excitation.trajectory import FourierSpec
    from flobaroid_tpu_torch.model import Model
    from flobaroid_tpu_torch.utils.config import load_config

    tmp = tmp_path_factory.mktemp("torch_walkman_flow")
    urdf = str(tmp / "humanoid30.urdf")
    shutil.copy(H30_URDF, urdf)
    shutil.copy(H30_URDF + ".regressor.npz", urdf + ".regressor.npz")
    opt = load_config(None, overrides=dict(
        floatingBase=1, floatingBaseAttachment="suspended",
        floatingBaseAttachmentFrame="crane_ft", suspendedDamping=500.0,
        useStructuralRegressor=1, randomSamples=2000, excitationFrequency=50.0,
        computeDtype="float64", verbose=0))
    model = Model(dict(opt), urdf, device="cpu")
    nd = model.num_dofs
    spec = FourierSpec(nf=(3,) * nd, limits=tuple(
        (float(model.limits[j]["lower"]), float(model.limits[j]["upper"]))
        for j in model.jointNames))
    x = initial_candidate(spec, dict(opt, trajectoryCoeffInit=0.25), np.random.default_rng(3))
    x[0] = 1.3
    meas = flow.simulate_stage(urdf, opt, model, spec, x, periods=8, device="cpu")
    n = len(meas["times"])
    cut = (n * 2) // 3
    train, heldout = {}, {}
    for k, v in meas.items():
        arr = np.asarray(v)
        if arr.ndim and arr.shape[0] == n:
            train[k], heldout[k] = arr[:cut], arr[cut:]
        else:
            train[k] = heldout[k] = v
    heldout["times"] = heldout["times"] - heldout["times"][0]
    paths = dict(urdf=urdf, train=str(tmp / "train.npz"), val=str(tmp / "val.npz"), n=n)
    np.savez(paths["train"], **train)
    np.savez(paths["val"], **heldout)
    return paths


@pytest.mark.timeout(240)
def test_walkman_flow_stages_meet_the_ci_gates(walkman_data):
    assert walkman_data["n"] == 1928
    idf = flow.identify_stage(walkman_data["urdf"], walkman_data["train"],
                              dict(flow.IDENTIFY_OPTIONS, computeDtype="float64"),
                              validation=walkman_data["val"], device="cpu")
    r = flow.report(idf)
    assert r["res_error"] < 5.0 and r["base_dist"] < 0.10
    assert r["sdp_status"] in ("optimal", "stalled") and r["consistent"]
    assert idf.val_nrms is not None and idf.val_nrms < 3.0
    assert np.median(np.abs(r["fc"] - flow.FC_TRUE)) < 0.15
    assert np.median(np.abs(r["fv"] - flow.FV_TRUE)) < 0.15


def _study(uniform, observability, geometric, geometric_obs):
    return {m: {"base_dist": v} for m, v in dict(
        uniform=uniform, observability=observability, geometric=geometric,
        geometric_obs=geometric_obs).items()}


@pytest.mark.parametrize("dists,want", [
    ((1.786, 1.551, 1.432, 1.431), True),  # the JAX package's figures (BENCH_r05)
    ((1.786, 1.551, 1.552, 1.55), True),  # geometric within 0.1 % above observability
    ((1.786, 1.551, 1.553, 1.55), False),
    ((1.5, 1.551, 1.432, 1.431), False),  # uniform not worst
    ((1.786, 1.551, 1.432, 1.2), False),  # geometric_obs 16 % off geometric
])
def test_cad_verdict_follows_the_jax_rule(dists, want):
    assert cad_quality_study.reproduced(_study(*dists)) is want


@pytest.mark.timeout(180)
def test_cad_quality_study_reproduces_from_the_checked_in_artifacts(capsys):
    assert cad_quality_study.main(["--device", "cpu"]) == 0
    assert "REPRODUCED" in capsys.readouterr().out
