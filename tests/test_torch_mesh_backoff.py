"""The port's mesh verification inside `optimize_trajectory`, CPU.

`optimize_trajectory` runs with every `collisionMode` and with
`fullMeshLinks` on the 7-DOF arm (a small budget, 157 samples); the
verdict it reports is held against the JAX package's verifier on the same
kinematics. The back-off (`_mesh_backoff_refine`) is driven by the
stand-in geometry of `tests/test_mesh_backoff.py` (`chip_smoke.StandInVerifier`,
which the chip script runs on the card), a fixed distance inside the
capsules of the pair whose clearance varies most, monkeypatched into the
port's `collision_mesh`; it must end verified with a D-optimality loss
under the JAX test's 5 %. That test runs with `minTolConstr` 0: under the
default tolerance of 1 cm the tightened constraint (4 mm beyond the
start) still counts as met at the start, so the refinement keeps the
start and only the amplitude shrink, the last resort, can end verified
(in both packages: the logic is the same).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu import collision_mesh as jcm
from flobaroid_tpu.collision import CollisionModel as JaxCollisionModel
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu_torch import collision_mesh
from flobaroid_tpu_torch.collision import CollisionModel
from flobaroid_tpu_torch.excitation import optimizer as topt
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.utils.config import load_config

from chip_smoke import StandInVerifier

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
CACHE = ".regressor.npz"  # the checked-in structural cache: 600 states
SMALL = dict(
    floatingBase=0, useStructuralRegressor=1, randomSamples=600, computeDtype="float64",
    excitationFrequency=25.0, trajectoryPulseMin=1.0, trajectoryPulseMax=1.5,
    trajectoryPulseInit=1.2, trajectoryDefaultNf=1, checkCollisions=1,
    globalOptSize=8, globalOptIterations=2, globalOptRestarts=1,
    localOptIterations=1, localOptStages=2, verbose=0,
)


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    d = tmp_path_factory.mktemp("arm")
    urdf = str(d / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + CACHE, urdf + CACHE)
    opt = load_config(None, overrides=SMALL)
    return urdf, opt, Model(dict(opt), urdf, device="cpu")


@pytest.mark.timeout(120)
def test_mesh_backoff_recovers_with_small_dopt_loss(arm, monkeypatch):
    urdf, opt, model = arm
    monkeypatch.setattr(collision_mesh, "MeshCollisionVerifier", StandInVerifier)
    StandInVerifier.geometry = None
    cfg = dict(opt, collisionMode="convex", minTolConstr=0.0)
    x, spec, obj, info = topt.optimize_trajectory(model, cfg, rng=np.random.default_rng(4))
    assert "dopt_before_backoff" in info, "the stand-in never triggered a violation"
    assert info["mesh_collision_ok"], "the back-off did not reach mesh feasibility"
    f0, f1 = info["dopt_before_backoff"], info["dopt_after_backoff"]
    assert (f1 - f0) / abs(f0) < 0.05
    assert info["dopt_backoff_loss_pct"] == round(100.0 * (f1 - f0) / abs(f0), 3)
    assert info["f_after_backoff"] == pytest.approx(obj.evaluate(x)[0], rel=1e-12)
    assert info["feasible"] and info["t_mesh_s"] >= 0
    # the report is on the unshifted constraints
    np.testing.assert_array_equal(obj._extra_shift, np.zeros(info["n_collision_pairs"]))


def test_mesh_failure_makes_the_result_infeasible(arm, monkeypatch):
    """A verification that stays failing after the back-off leaves the
    result infeasible, whatever the capsule constraints say."""
    urdf, opt, model = arm

    class AlwaysViolated(StandInVerifier):
        def verify(self, Q, base_rot=None, base_pos=None, step=1, tol=1e-3):
            return False, [(self.pair_names[0], -0.01)]

    calls = []

    def no_recovery(config, spec, obj, cm, ver, x, bad, *rest):
        calls.append(bad)
        return x, False, bad

    monkeypatch.setattr(collision_mesh, "MeshCollisionVerifier", AlwaysViolated)
    monkeypatch.setattr(topt, "_mesh_backoff_refine", no_recovery)
    x, spec, obj, info = topt.optimize_trajectory(
        model, dict(opt, collisionMode="box", localOptStages=1), rng=np.random.default_rng(4))
    assert len(calls) == 1 and info["mesh_collision_ok"] is False
    assert obj.feasible(obj.evaluate(x)[1]) and not info["feasible"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["box", "convex", "full", "full_links"])
def test_optimize_trajectory_runs_every_collision_mode(arm, mode):
    """No mode raises; `info` carries the verdict and its time, and the
    verdict equals the JAX package's verifier on the result's kinematics."""
    urdf, opt, model = arm
    cfg = dict(opt, collisionMode=mode, localOptStages=1)
    if mode == "full_links":
        cfg.update(collisionMode="convex", fullMeshLinks=["arm_3_link", "arm_7_link"])
    x, spec, obj, info = topt.optimize_trajectory(model, cfg, rng=np.random.default_rng(4))
    assert {"mesh_collision_ok", "t_mesh_s"} <= set(info)
    assert info["feasible"] == (obj.feasible(obj.evaluate(x)[1]) and info["mesh_collision_ok"])
    Q, BR, BP = obj.kinematics(x)
    Qb, BRb, BPb = obj.kinematics_batch(np.stack([x, x]))
    np.testing.assert_array_equal(Qb[1], Q)
    assert BR is BP is BRb is BPb is None and Q.shape == (obj.num_samples, model.num_dofs)
    jt = jax_load_urdf(urdf)
    jcap = JaxCollisionModel(jt, JaxEngine(jt), cfg)
    jv = jcm.MeshCollisionVerifier(jt, JaxEngine(jt), cfg, jcap)
    step = int(cfg.get("collisionCheckStep", 3))
    ok, _ = jv.verify(Q, step=step)
    assert ok == info["mesh_collision_ok"]
    tcap = CollisionModel(model.tree, model.engine, cfg)
    assert tcap.pair_names == jcap.pair_names and info["n_collision_pairs"] == tcap.num_pairs
    tv = collision_mesh.MeshCollisionVerifier(model.tree, model.engine, cfg, tcap, device="cpu")
    np.testing.assert_allclose(tv.min_clearances(Q, step=step), jv.min_clearances(Q, step=step),
                               atol=1e-5)


def test_candidate_sharding_raises(arm):
    """Candidate sharding runs (the name is kept from when it raised):
    with the exact-mesh verification of the convex tier,
    `optimize_trajectory` with the CEM batch and the AL restarts split
    over two shards ends where the unsharded run ends, with the same
    verdicts."""
    urdf, opt, model = arm
    runs = [topt.optimize_trajectory(
        model, dict(opt, collisionMode="convex", globalOptIterations=1, localOptStages=1,
                    shardCandidates=shards),
        rng=np.random.default_rng(4)) for shards in (0, 2)]
    (x0, _, _, info0), (x2, _, obj2, info2) = runs
    assert obj2._candidate_mesh().size == 2
    np.testing.assert_allclose(x2, x0, rtol=1e-10, atol=1e-12)
    assert info2["f"] == pytest.approx(info0["f"], rel=1e-10)
    assert (info2["feasible"], info2["mesh_collision_ok"]) == (
        info0["feasible"], info0["mesh_collision_ok"])
