"""The port's model analyses against the JAX package, CPU, f64.

The 7-DOF arm in four parameter layouts (inertial, with friction, gravity
only, floating base); the port's model carries the JAX model's structural
projection over with `convert.py`, so both analyse one K. Held exactly:
`getDescriptionOfParameters`, the parameter names and `base_equations_str`
are string-equal, `structural_identifiability` is dict-equal, and
`sensor_placement_study` gives equal ranks, gains and null directions
(its states come from jax.random in the JAX package and from a
torch.Generator in the port, so the Grams differ in value, not in rank).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu.model import Model as JaxModel
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.convert import state_from_jax_model
from flobaroid_tpu_torch.model import Model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
LAYOUTS = {
    "inertial": dict(floatingBase=0, randomSamples=600),  # the checked-in cache
    "friction": dict(floatingBase=0, randomSamples=300, identifyFrictionSimultaneously=1,
                     identifySymmetricVelFriction=0, stribeckVelocity=0.1),
    "gravity": dict(floatingBase=0, randomSamples=400, identifyGravityParamsOnly=1,
                    identifyFrictionSimultaneously=1),
    "floating": dict(floatingBase=1, randomSamples=300),
}


@pytest.fixture(scope="module")
def arm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("arm")
    for suffix in ("", ".regressor.npz", ".gravity_regressor.npz"):
        shutil.copy(ARM_URDF + suffix, str(d / "arm.urdf") + suffix)
    return str(d / "arm.urdf")


def _pair(urdf, layout):
    opt = load_config(None, overrides=dict(LAYOUTS[layout], useStructuralRegressor=1,
                                           computeDtype="float64", verbose=0))
    jm = JaxModel(dict(opt), urdf)
    tm = Model(dict(opt), urdf, regressor_init=False, device="cpu")
    tm.load_state(state_from_jax_model(jm))
    return jm, tm


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_descriptions_equations_and_identifiability_equal_jax(arm_dir, layout):
    jm, tm = _pair(arm_dir, layout)
    assert tm.getDescriptionOfParameters() == jm.getDescriptionOfParameters()
    assert tm._friction_block_names() == jm._friction_block_names()
    assert tm.param_names == jm.param_names and len(tm.param_names) == tm.num_all_params
    assert tm.base_equations_str() == jm.base_equations_str()
    assert tm.base_equations_str(tol=1e-3) == jm.base_equations_str(tol=1e-3)
    assert len(tm.base_equations_str()) == tm.num_base_params
    got = tm.structural_identifiability()
    assert got == jm.structural_identifiability()
    assert got["base_directions"] + got["null_directions"] == got["n_inertial_params"]


@pytest.mark.parametrize("layout", ["inertial", "floating"])
def test_sensor_placement_ranks_equal_jax(arm_dir, layout):
    jm, tm = _pair(arm_dir, layout)
    sets = {"wrist": ["arm_7_link"], "elbow": ["arm_3_link"],
            "both": ["arm_3_link", "arm_7_link"]}
    want = jm.sensor_placement_study(sets, n_samples=300)
    got = tm.sensor_placement_study(sets, n_samples=300)
    assert got == want
    assert got["sets"]["wrist"]["gain"] > 0


def test_identifiability_needs_the_projection(arm_dir):
    opt = load_config(None, overrides=dict(LAYOUTS["inertial"], verbose=0))
    with pytest.raises(ValueError, match="computeRegressorLinDepsQR"):
        Model(dict(opt), arm_dir, regressor_init=False, device="cpu").structural_identifiability()


def test_shard_samples_raises_before_any_work(arm_dir):
    """Sample sharding runs (the name is kept from when it raised): with
    `shardSamples: 2` the streamed Grams, the contractions and the
    residual statistics of every layout's model equal the unsharded
    model's, and each piece of the data lies on its shard's device."""
    from flobaroid_tpu_torch.data import Data

    rng = np.random.default_rng(3)
    for layout in LAYOUTS:
        models = []
        for shards in (0, 2):
            opt = load_config(None, overrides=dict(
                LAYOUTS[layout], useStructuralRegressor=1, computeDtype="float64",
                materializeRegressor=0, gramChunk=64, simulateTorques=1, shardSamples=shards,
                verbose=0))
            models.append(Model(dict(opt), arm_dir, device="cpu"))
        m0, m2 = models
        n, N = m0.num_dofs, 150
        samples = dict(positions=rng.uniform(-1, 1, (N, n)), velocities=rng.normal(size=(N, n)),
                       accelerations=rng.normal(size=(N, n)), torques=np.zeros((N, n)),
                       times=np.arange(N) / 100.0, frequency=np.float64(100.0))
        if m0.fb:
            samples.update(base_rpy=rng.uniform(-0.1, 0.1, (N, 3)),
                           base_velocity=rng.normal(size=(N, 6)),
                           base_acceleration=rng.normal(size=(N, 6)))
        for m in models:
            data = Data(m.opt)
            data.init_from_data({k: np.array(v) for k, v in samples.items()})
            m.computeRegressors(data)
        pieces = [p["sl"] for p in m2._staged["parts"]]
        assert [(s.start, s.stop) for s in pieces] == [
            (0, 32), (32, 64), (64, 96), (96, 128), (128, 139), (139, 150)], layout
        scale = np.abs(m0.G_rows.numpy()).max()
        assert np.abs(m2.G_rows.numpy() - m0.G_rows.numpy()).max() <= 1e-12 * scale, layout
        np.testing.assert_allclose(m2.g_rows.numpy(), m0.g_rows.numpy(), rtol=1e-10, atol=1e-10)
        x = m0.xStdModel[m0.identified_params] * 1.05
        np.testing.assert_allclose(m2.contract_identified(x), m0.contract_identified(x),
                                   rtol=1e-12, atol=1e-12)
        (r2,), (r0,) = m2.residual_stats([x]), m0.residual_stats([x])
        for k in ("rp", "pp", "tp", "bn"):
            np.testing.assert_allclose(r2[k], r0[k], rtol=1e-10)
