"""The port's sharding (`parallel/`, `shardSamples`) against the JAX
package and against its own unsharded runs, on the CPU in f64.

The port shards in one process: shard i's slice goes to mesh device i
(on the CPU every shard is `cpu`, the counterpart of the JAX tests'
eight virtual host devices) and the partial results are summed in f64 on
the primary device in shard order, so a sharded run differs from the
unsharded one by summation order only. Tolerances: `sharded_gram_fn`
1e-10 relative against the JAX one; the streamed identify at 2 and 8
shards against the JAX package's and the port's unsharded runs, xBase
1e-10 relative and the residual 1e-8 points; the walking-contact
identify (floating base, foot wrenches) < 1e-8 relative in xBase, the
base Gram and the contact torques; the structural random Gram the same
rank and within 1e-12 of max|G|. Candidate sharding is held in
test_torch_optimizer.py, on the objectives that module compiles once.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.identification.identifier import Identification as JaxIdentification
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu.parallel import mesh as jmesh
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.models.urdf import load_urdf
from flobaroid_tpu_torch.parallel import mesh
from flobaroid_tpu_torch.parallel.dryrun import dryrun_multichip, entry

from test_dynamics import SIMPLE_URDF
from test_identification import synth_samples

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module")
def arm_copy(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_arm")
    for suffix in ("", ".regressor.npz"):
        shutil.copy(ARM_URDF + suffix, str(d / "arm.urdf") + suffix)
    return str(d / "arm.urdf")


def test_make_mesh_places_shards_and_needs_a_device(monkeypatch):
    m = mesh.make_mesh(8, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 8 and m.axis == "samples" and m.size == 8
    assert mesh.make_mesh(device="cpu", axis="candidates").size == 1
    with pytest.raises(ValueError):
        mesh.make_mesh(2, device=None)
    with pytest.raises(ValueError):
        mesh.make_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(2)


def test_make_mesh_starts_on_the_callers_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = mesh.make_mesh(3, device="cuda:1")
    assert m.devices == tuple(torch.device("cuda", i) for i in (1, 0, 1))
    assert "3 shards share 2 card(s)" in capsys.readouterr().out
    assert mesh.make_mesh(2, device="cuda").devices == (torch.device("cuda", 0),
                                                         torch.device("cuda", 1))


@pytest.mark.parametrize("shape,m", [((13, 3), 8), ((16, 2, 2), 8), ((5,), 1), ((0, 4), 3)])
def test_pad_to_multiple_matches_jax(shape, m):
    a = np.random.default_rng(0).standard_normal(shape)
    (pt, nt), (pj, nj) = mesh.pad_to_multiple(a, m), jmesh.pad_to_multiple(a, m)
    assert nt == nj and pt.dtype == pj.dtype and np.array_equal(pt, pj)


def test_shard_batch_matches_jax():
    """The shards of a batch whose length the mesh divides are the JAX
    mesh's device shards, in device order; a ragged length gives slices
    of ceil(N / n) rows with empty shards left out."""
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((64, 3)), rng.standard_normal((64, 2, 2))
    tshards = mesh.shard_batch(mesh.make_mesh(8, device="cpu"), a, b)
    jshards = jmesh.shard_batch(jmesh.make_mesh(8), a, b)
    for ts, js in zip(tshards, jshards):
        by_device = sorted(js.addressable_shards, key=lambda s: s.device.id)
        assert len(ts) == len(by_device) == 8
        for t, j in zip(ts, by_device):
            assert np.array_equal(t.numpy(), np.asarray(j.data))
    (ragged,) = mesh.shard_batch(mesh.make_mesh(4, device="cpu"), np.arange(5.0))
    assert [t.tolist() for t in ragged] == [[0.0, 1.0], [2.0, 3.0], [4.0]]
    assert mesh.shard_slices(0, 3) == []


def test_sharded_gram_fn_matches_jax():
    N = 64
    jt, tt = jax_load_urdf(SIMPLE_URDF), load_urdf(SIMPLE_URDF)
    n = tt.num_dofs
    rng = np.random.default_rng(3)
    Q, DQ, DDQ, TAU = (rng.uniform(-1, 1, (N, n)), rng.standard_normal((N, n)),
                       rng.standard_normal((N, n)), rng.standard_normal((N, n)))
    jm = jmesh.make_mesh(8)
    Gj, gj = jmesh.sharded_gram_fn(JaxEngine(jt), jm)(*jmesh.shard_batch(jm, Q, DQ, DDQ, TAU))
    tm = mesh.make_mesh(8, device="cpu")
    Gt, gt = mesh.sharded_gram_fn(DynamicsEngine(tt), tm)(*mesh.shard_batch(tm, Q, DQ, DDQ, TAU))
    assert Gt.dtype == torch.float64 and Gt.shape == Gj.shape
    assert _rel(Gt.numpy(), Gj) <= 1e-10 and _rel(gt.numpy(), gj) <= 1e-10


@pytest.fixture(scope="module")
def streamed(arm_copy):
    """The streamed identify of 900 noisy samples (numpy seed 17) on the
    checked-in structural cache, unsharded, in both packages."""
    samples, _ = synth_samples(arm_copy, n=900, noise=0.05, seed=17)
    runs = {}
    for cls in (JaxIdentification, Identification):
        kw = {} if cls is JaxIdentification else dict(device="cpu")
        idf = cls(_streamed_opt(0), arm_copy, **kw)
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        runs[cls] = idf
    return samples, runs[JaxIdentification], runs[Identification]


def _streamed_opt(shards):
    return load_config(None, overrides=dict(
        floatingBase=0, useStructuralRegressor=1, randomSamples=600, computeDtype="float64",
        estimateWith="std", materializeRegressor=0, gramChunk=256, shardSamples=shards,
        verbose=0))


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_streamed_identify_matches_unsharded(arm_copy, streamed, shards):
    samples, jax_run, port_run = streamed
    idf = Identification(_streamed_opt(shards), arm_copy, device="cpu")
    idf.data.init_from_data(dict(samples))
    idf.estimateParameters()
    # 900 samples in chunks of 256 (a multiple of both shard counts)
    assert len(idf.model._staged["parts"]) == 4 * shards
    for ref in (port_run, jax_run):
        assert _rel(idf.model.xBase, ref.model.xBase) <= 1e-10
        assert abs(idf.res_error - ref.res_error) <= 1e-8
    assert _rel(idf.model.G_std, port_run.model.G_std) <= 1e-12


def test_sharded_walking_contact_matches_unsharded(tmp_path):
    """humanoid30, floating base, two foot wrenches (the walking
    scenario's, 896 samples), chunks of 96 over 8 shards: the contact
    J^T w, the per-channel Grams and the identify equal the unsharded
    run's."""
    from flobaroid_tpu_torch.simulation.scenarios import walking_contact_scenario

    for suffix in ("", ".regressor.npz"):
        shutil.copy(H30_URDF + suffix, str(tmp_path / "h30.urdf") + suffix)
    urdf = str(tmp_path / "h30.urdf")

    def opt_for(shards):
        return load_config(None, overrides=dict(
            floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
            useStructuralRegressor=1, randomSamples=2000, materializeRegressor=0,
            estimateWith="std", constrainToConsistent=0, computeDtype="float64",
            gramChunk=96, shardSamples=shards, verbose=0))

    gen = Model(opt_for(0), urdf, device="cpu")
    samples, _, _ = walking_contact_scenario(gen, N=896, freq=200.0, seed=5, torque_noise=0.02,
                                             wrench_noise=0.3)
    res = {}
    for shards in (0, 8):
        idf = Identification(opt_for(shards), urdf, device="cpu")
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        m = idf.model
        res[shards] = (m.xBase, m.G_base, m.contactForcesSum, idf.res_error)
    for a, b in zip(res[8][:3], res[0][:3]):
        assert _rel(a, b) < 1e-8
    assert abs(res[8][3] - res[0][3]) < 1e-8 and res[8][3] < 1.0


def test_sharded_random_gram_draws_the_same_states(arm_copy):
    """The structural Gram with friction columns (P = 101) over 1000
    states in chunks of 400, split over 3 shards (ragged: 134, 134, 132
    rows of states and 67, 67, 66 in the tail): the same draws, so the
    same rank, and the Gram within 1e-12 of max|G|."""
    def model(shards):
        return Model(load_config(None, overrides=dict(
            floatingBase=0, identifyFrictionSimultaneously=1, useStructuralRegressor=1,
            randomSamples=1000, computeDtype="float64", gramChunk=400, shardSamples=shards,
            verbose=0)), arm_copy, regressor_init=False, device="cpu")

    m0, m3 = model(0), model(3)
    G0, G3 = m0._random_gram(1000), m3._random_gram(1000)
    assert np.abs(G3 - G0).max() <= 1e-12 * np.abs(G0).max()
    ranks = []
    for m, G in ((m0, G0), (m3, G3)):
        m.computeRegressorLinDepsQR(G)
        ranks.append(m.num_base_params)
    assert ranks[0] == ranks[1] > 0


def test_entry_matches_jax():
    """The single-step entry: the arm's Gram (through the Gram
    wrapper) and torques on the JAX entry's inputs, f32 on both sides."""
    import __graft_entry__ as g

    jfn, jargs = g.entry()
    Gj, tj = jax.jit(jfn)(*jargs)
    fn, args = entry(device="cpu")
    for a, ja in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(ja))
    G, tau = fn(*args)
    assert G.dtype == tau.dtype == torch.float32
    assert np.abs(G.numpy() - np.asarray(Gj)).max() <= 1e-5 * np.abs(np.asarray(Gj)).max()
    assert np.abs(tau.numpy() - np.asarray(tj)).max() <= 1e-5 * np.abs(np.asarray(tj)).max()


@pytest.mark.timeout(180)
def test_dryrun_multichip_on_four_cpu_shards():
    """The five production sharded paths, each against its unsharded run
    (1e-8 in f64), with MULTICHIP_r05's line printed."""
    out = dryrun_multichip(4, device="cpu")
    assert out["n_devices"] == 4 and out["device"] == "cpu"
    for k in ("identify_rel_err", "walking_rel_err", "random_gram_rel_err", "al_x_rel_err",
              "cem_f_rel_err", "cem_g_rel_err"):
        assert out[k] < 1e-8, (k, out[k])
    assert np.isfinite(out["cem_best_f"]) and np.isfinite(out["al_f"])
