"""The port's streamed Model against the JAX Model on the same samples.

The URDF and its checked-in structural caches are copied into a
temporary directory (nothing is written next to the repository's
models), and the port installs the JAX model's projection through
convert.py, so base-space quantities compare value for value.
Tolerances: 1e-10 relative in f64 (same formulas, rounding order only),
1e-5 of max|G| in f32 (f32 regressor chunks; the JAX scan carries the sum
in f32, the port in f64).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu.data import Data as JaxData
from flobaroid_tpu.model import Model as JaxModel
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.data import Data
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.ops import gram as tgram

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
CASES = {  # inertial and gravity_only hit a checked-in structural cache
    "inertial": dict(randomSamples=600),
    "friction": dict(randomSamples=600, identifyFrictionSimultaneously=1),
    "gravity_only": dict(randomSamples=400, identifyGravityParamsOnly=1),
}
TOL = {"float64": 1e-10, "float32": 1e-5}


@pytest.fixture(scope="module")
def arm_copy(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_model_arm")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz", ARM_URDF + ".gravity_regressor.npz"):
        shutil.copy(f, d)
    return str(d / "sevenlink_arm.urdf")


def _opt(case, dtype, **kw):
    return load_config(None, overrides={
        **dict(floatingBase=0, useStructuralRegressor=1, materializeRegressor=0,
               computeDtype=dtype, gramChunk=128, verbose=0),
        **CASES[case], **kw})


def _samples(n=300, seed=7, nd=7):
    rng = np.random.default_rng(seed)
    return {
        "positions": rng.uniform(-1.5, 1.5, (n, nd)),
        "velocities": rng.standard_normal((n, nd)),
        "accelerations": rng.standard_normal((n, nd)) * 3,
        "torques": rng.standard_normal((n, nd)) * 5,
        "times": np.arange(n) / 200.0,
        "frequency": np.array(200.0),
    }


def _pair(urdf, case, dtype, **kw):
    """(JAX model, port model with the JAX projection), both after
    computeRegressors on the same samples."""
    jm = JaxModel(_opt(case, dtype, **kw), urdf)
    tm = Model(_opt(case, dtype, **kw), urdf, regressor_init=False, device="cpu")
    tm.load_state(state_from_jax_model(jm))
    s = _samples()
    for m, D in ((jm, JaxData), (tm, Data)):
        d = D(m.opt)
        d.init_from_data(dict(s))
        m.computeRegressors(d)
    return jm, tm


def _rel(t, j):
    t, j = np.asarray(t, dtype=float), np.asarray(j, dtype=float)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_streamed_grams_match_jax(arm_copy, case, dtype):
    jm, tm = _pair(arm_copy, case, dtype)
    assert tm.num_base_params == jm.num_base_params
    assert tm.G_rows.device.type == "cpu"
    pairs = {
        "G_rows": (tm.G_rows.numpy(), jm.G_rows),
        "g_rows": (tm.g_rows.numpy(), jm.g_rows),
        "G_base": (tm.G_base, jm.G_base),
        "g_base": (tm.g_base, jm.g_base),
    }
    for name, (t, j) in pairs.items():
        assert np.shape(t) == np.shape(j), name
        assert _rel(t, j) < TOL[dtype], (name, _rel(t, j))
    assert abs(tm.tau_sq - jm.tau_sq) <= 1e-12 * jm.tau_sq
    assert np.abs(tm.gcf_rows.numpy()).max() == 0.0  # no contacts on this path


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_apriori_simulation_matches_jax(arm_copy, dtype):
    """simulateTorques: the a-priori torques the streamed pass simulates
    (Y_id @ x_id over the staged chunks) and the residual statistics."""
    jm, tm = _pair(arm_copy, "friction", dtype, simulateTorques=1)
    assert _rel(tm.tauMeasured, jm.tauMeasured) < TOL[dtype]
    x = jm.xStdModel[jm.identified_params] * 1.01
    sj, st = jm.residual_stats([x])[0], tm.residual_stats([x])[0]
    for k in ("rp", "pp", "tp"):
        assert _rel(st[k], sj[k]) < 10 * TOL[dtype], k
    assert _rel(tm.contract_identified(x), np.asarray(jm.contract_identified(x))) < TOL[dtype]


def test_materialized_regressor_matches_jax(arm_copy):
    jm, tm = _pair(arm_copy, "friction", "float64", materializeRegressor=1)
    assert _rel(tm.YStd, jm.YStd) < 1e-10
    assert _rel(tm.YBase, jm.YBase) < 1e-10


def test_convert_carries_the_projection(arm_copy):
    jm = JaxModel(_opt("inertial", "float64"), arm_copy)
    st = state_from_jax_model(jm)
    cached = np.load(arm_copy + ".regressor.npz")
    np.testing.assert_allclose(st["R"], cached["R"], rtol=0, atol=1e-9 * np.abs(cached["R"]).max())
    tm = Model(_opt("inertial", "float64"), arm_copy, regressor_init=False, device="cpu")
    tm.load_state(st)
    for k in ("Pb", "Pd", "K"):
        assert np.array_equal(getattr(tm, k), getattr(jm, k)), k
    assert tm.num_base_params == jm.num_base_params == 43
    assert tm.non_id == jm.non_id


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_structural_rank_and_column_space(tmp_path, dtype):
    """The port draws its structural states from a torch.Generator, so its
    structural Gram differs in value from JAX's: its rank and column space
    must not. Fresh URDF copies (cache miss: both compute the Gram)."""
    urdfs = []
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
        urdfs.append(str(tmp_path / sub / "arm.urdf"))
        shutil.copy(ARM_URDF, urdfs[-1])
    kw = dict(randomSamples=300, gramChunk=512)
    jm = JaxModel(_opt("inertial", dtype, **kw), urdfs[0])
    before = tgram.launches
    tm = Model(_opt("inertial", dtype, **kw), urdfs[1], device="cpu")
    assert tgram.launches == before  # the CPU path runs the plain version
    assert tm.num_base_params == jm.num_base_params == 43
    assert tm._structural_gram_dtype == jm._structural_gram_dtype
    if dtype == "float64":
        r = tm.num_base_params
        bases = []
        for u in urdfs:
            G = np.load(u + ".regressor.npz")["R"]
            bases.append(np.linalg.eigh(G)[1][:, -r:])
        cos = np.linalg.svd(bases[0].T @ bases[1], compute_uv=False)
        assert np.arccos(np.clip(cos, -1.0, 1.0)).max() < 1e-6


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_floating_structural_rank_and_column_space(tmp_path, dtype):
    """The same for a floating base with friction columns: base velocity,
    acceleration and tilt are drawn too, and the friction blocks are zero
    in the 6 base-wrench rows. The cache is keyed fb=1."""
    urdfs = []
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
        urdfs.append(str(tmp_path / sub / "arm.urdf"))
        shutil.copy(ARM_URDF, urdfs[-1])
    kw = dict(randomSamples=200, gramChunk=128, floatingBase=1)
    jm = JaxModel(_opt("friction", dtype, **kw), urdfs[0])
    tm = Model(_opt("friction", dtype, **kw), urdfs[1], device="cpu")
    assert tm.num_base_params == jm.num_base_params == 80
    cache = np.load(urdfs[1] + ".regressor.npz")
    assert int(cache["fb"]) == 1 and int(cache["n"]) == 200
    if dtype == "float64":
        r = tm.num_base_params
        bases = [np.linalg.eigh(np.load(u + ".regressor.npz")["R"])[1][:, -r:] for u in urdfs]
        cos = np.linalg.svd(bases[0].T @ bases[1], compute_uv=False)
        assert np.arccos(np.clip(cos, -1.0, 1.0)).max() < 1e-6


def test_model_requires_a_device_and_fixed_base(arm_copy, monkeypatch):
    """The default device is the card: without one it raises, with no CPU
    fallback. A floating base and the friction refit are ported; what
    stays unported on a model's path (candidate sharding of the trajectory
    optimizer and sample sharding of the identify) raises, naming
    ROADMAP."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(_opt("inertial", "float64"), arm_copy)
    with pytest.raises(ValueError):
        Model(_opt("inertial", "float64"), arm_copy, device=None)
    idf = Identification(_opt("friction", "float64", postIdentifyFriction=1), arm_copy,
                         device="cpu")
    idf.data.init_from_data(_samples())
    idf.estimateParameters()
    assert set(idf.postid_friction) == {"Fc", "Fv", "off"}
    from flobaroid_tpu_torch.excitation.optimizer import optimize_trajectory

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimize_trajectory(idf.model, {**idf.opt, "shardCandidates": 2})
    sharded = Identification(_opt("friction", "float64", shardSamples=2), arm_copy, device="cpu")
    sharded.data.init_from_data(_samples())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sharded.estimateParameters()


def test_convert_carries_the_base_and_refuses_a_mismatch(arm_copy):
    """state_from_jax_model carries fb; a fixed-base port model refuses
    a floating-base state (its projection is of another regressor)."""
    jm = JaxModel(_opt("inertial", "float64", floatingBase=1, randomSamples=300), arm_copy)
    st = state_from_jax_model(jm)
    assert int(st["fb"]) == jm.fb == 6
    tm = Model(_opt("inertial", "float64", floatingBase=1), arm_copy, regressor_init=False,
               device="cpu")
    tm.load_state(st)
    assert tm.num_base_params == jm.num_base_params
    fixed = Model(_opt("inertial", "float64"), arm_copy, regressor_init=False, device="cpu")
    with pytest.raises(ValueError, match="floatingBase"):
        fixed.load_state(st)


@pytest.mark.parametrize("case", ["inertial", "friction"])
def test_simulate_dynamics_matches_jax(arm_copy, case):
    jm = JaxModel(_opt(case, "float64"), arm_copy, regressor_init=False)
    tm = Model(_opt(case, "float64"), arm_copy, regressor_init=False, device="cpu")
    s = _samples(n=200, seed=9)
    idx = np.arange(0, 200, 2)
    x = jm.xStdModel * 1.1
    assert _rel(tm.simulate_dynamics(s, idx, x), jm.simulate_dynamics(s, idx, x)) < 1e-10
    assert _rel(tm.simulate_dynamics(s, idx), jm.simulate_dynamics(s, idx)) < 1e-10


def test_streamed_grams_with_subsampling_match_jax(arm_copy):
    """skipSamples > 0: every second sample enters the Grams."""
    jm, tm = _pair(arm_copy, "friction", "float64", skipSamples=1, simulateTorques=1)
    assert tm.tauMeasured.shape == jm.tauMeasured.shape == (150, 7)
    assert _rel(tm.G_rows.numpy(), jm.G_rows) < 1e-10
    assert _rel(tm.g_rows.numpy(), jm.g_rows) < 1e-10
