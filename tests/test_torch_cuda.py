"""Tests of the port that need a CUDA device (marker `cuda`).

They skip inside the test where there is no card. This file imports
neither JAX nor the JAX package's test helpers, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
import shutil

import numpy as np
import pytest
import torch

from flobaroid_tpu_torch import model as model_mod
from flobaroid_tpu_torch.identification import conic
from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.ops import gram as tgram
from flobaroid_tpu_torch.simulation.scenarios import walking_contact_scenario
from flobaroid_tpu_torch.utils import graphs, timing
from flobaroid_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("N,B,C", [(14000, 1, 80), (2000, 7, 82), (1037, 1, 37), (5, 3, 1),
                                   (13770, 30, 342), (60000, 7, 82), (777, 2, 201),
                                   (4096, 36, 432), (1482, 36, 432), (72000, 1, 430),
                                   (1000, 36, 432)])
def test_gram_kernel_matches_plain(cuda_device, N, B, C):
    """Kernel vs the plain version in f64 on the same inputs: 1e-5 of
    max|G| (split-TF32 tensor cores, partials summed in f64), one launch
    per call, whatever the layout: contiguous (copied first when C is not
    a multiple of 4), a channel-major strided view, and the Gram sites'
    padded view with C not a multiple of 4."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    Y = torch.randn((N, B, C), generator=g, device=cuda_device)
    before = tgram.launches
    Gk = tgram.gram_batched(Y)
    torch.cuda.synchronize()
    assert tgram.launches == before + 1
    G64 = tgram.gram_plain(Y.double())
    assert float((Gk.double() - G64).abs().max() / G64.abs().max()) <= 1e-5
    assert torch.equal(Gk, tgram.gram_batched(Y))  # no atomics: bitwise reproducible
    assert torch.equal(Gk, Gk.transpose(1, 2))
    Yt = Y.permute(1, 0, 2).contiguous().permute(1, 0, 2)  # strided view
    assert torch.equal(tgram.gram_batched(Yt), Gk)
    Yp = tgram.cat_padded([Y])  # rows padded to 16 bytes, read in place
    before = tgram.launches
    assert torch.equal(tgram.gram_batched(Yp), Gk)
    assert tgram.launches == before + 1


def test_gram_wrapper_raises_instead_of_falling_back(cuda_device):
    Y = torch.randn((64, 2, 9), device=cuda_device)
    with pytest.raises(TypeError):
        tgram.gram_batched(Y.double())  # the kernel is f32 only
    with pytest.raises(ValueError):
        tgram.gram_batched(Y, out=torch.empty((2, 9, 9), device=cuda_device).transpose(1, 2))
    assert torch.equal(tgram.gram_batched(Y[:0]), torch.zeros((2, 9, 9), device=cuda_device))


def test_slice_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The streamed identify on the card (kernel in both Gram sites)
    against the same port on the CPU (plain versions), on the checked-in
    structural cache so both use one projection."""
    urdf = str(tmp_path / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + ".regressor.npz", urdf + ".regressor.npz")
    opt = dict(floatingBase=0, simulateTorques=1, useStructuralRegressor=1, randomSamples=600,
               estimateWith="std", materializeRegressor=0, constrainToConsistent=1,
               limitOverallMass=1, limitMassRange=1.0, limitMassToApriori=1,
               limitMassAprioriBoundary=0.3, verbose=0, gramChunk=256)
    rng = np.random.default_rng(42)
    n, nd = 800, 7
    samples = dict(positions=rng.uniform(-1.5, 1.5, (n, nd)),
                   velocities=rng.standard_normal((n, nd)),
                   accelerations=rng.standard_normal((n, nd)) * 3,
                   torques=np.zeros((n, nd)), times=np.arange(n) / 200.0,
                   frequency=np.array(200.0))
    out = {}
    for dev in ("cuda", "cpu"):
        before = tgram.launches
        idf = Identification(load_config(None, overrides=opt), urdf, device=dev)
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        out[dev] = (idf, tgram.launches - before)
    (g, g_launches), (c, c_launches) = out["cuda"], out["cpu"]
    assert g.model.G_rows.device.type == "cuda"
    assert g_launches >= 4 and c_launches == 0  # ceil(800 / 256) chunks per pass
    assert g.sdp.last_status == c.sdp.last_status == "optimal"
    xg, xc = g.model.xBase, c.model.xBase
    assert np.linalg.norm(xg - xc) <= 1e-4 * np.linalg.norm(xc)
    assert abs(g.res_error - c.res_error) <= 1e-3


# ----------------------------------------------------------------------
# the streamed regressor build replayed from CUDA graphs (utils/graphs.py)
# ----------------------------------------------------------------------
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
CHUNK_FIELDS = ("Q", "V", "A", "BR", "BV", "BA", "vsig")


def _arm_samples(n, seed=0, nd=7):
    rng = np.random.default_rng(seed)
    return dict(positions=rng.uniform(-1.5, 1.5, (n, nd)),
                velocities=rng.standard_normal((n, nd)),
                accelerations=rng.standard_normal((n, nd)) * 3,
                torques=rng.standard_normal((n, nd)), times=np.arange(n) / 200.0,
                frequency=np.array(200.0))


def _staged(model, samples):
    idx = np.arange(len(samples["positions"]))
    return model._stage_streaming(samples, idx, *model._gather_state(samples, idx))


def _eager(model, st):
    return [model._chunk_build(*(p[k] for k in CHUNK_FIELDS)) for p in st["parts"]]


def _passes_equal_eager(model, st, passes=7):
    """`passes` passes over the staged pieces, every piece kept: each equals
    the eager build of its piece bit for bit, with the same strides, so no
    replay overwrote a piece handed out before it. Seven passes take a
    one-piece dataset through its eager builds, its capture and two
    replays."""
    kept = [list(model._identified_chunks(st)) for _ in range(passes)]
    eager = _eager(model, st)
    for pieces in kept:
        assert [sl for sl, _ in pieces] == [p["sl"] for p in st["parts"]]
        for (_, Y), E in zip(pieces, eager):
            assert Y.shape == E.shape and Y.stride() == E.stride()
            assert torch.equal(Y, E)
    return kept


def _graphs_held(model):
    return sum(isinstance(g, graphs.Captured)
               for cache in model._graphs.values() for g in cache.entries.values())


GRAPH_CASES = {  # (urdf, options, samples, piece rows)
    "arm-4096-2656": ("arm", dict(gramChunk=4096), 4096 + 2656, [4096, 2656]),
    "arm-2000": ("arm", dict(gramChunk=4096), 2000, [2000]),
    "arm-gravity-only": ("arm", dict(gramChunk=1024, identifyGravityParamsOnly=1), 1500,
                         [1024, 476]),
    "arm-4-shards": ("arm", dict(gramChunk=4096, shardSamples=4), 4096 + 2656,
                     [1024] * 4 + [664] * 4),
    "h30-friction": ("h30", dict(gramChunk=1024, floatingBase=1, identifyFrictionSimultaneously=1,
                                 identifySymmetricVelFriction=0), 1500, [1024, 476]),
    "h30-friction-stribeck": ("h30", dict(gramChunk=1024, floatingBase=1,
                                          identifyFrictionSimultaneously=1,
                                          identifySymmetricVelFriction=0, stribeckVelocity=0.1),
                              1500, [1024, 476]),
}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_replayed_chunk_build_equals_eager(cuda_device, case):
    """A shape's first builds eager, its `GRAPH_CAPTURE_AT`-th captured,
    later ones replayed: every piece equals its eager build bit for bit,
    the model holds one graph per piece shape, and the counters of the
    traced passes say so (`regressor_graph_captures` one per shape)."""
    robot, over, n, rows = GRAPH_CASES[case]
    opt = load_config(None, overrides=dict(materializeRegressor=0, verbose=0, **over))
    m = model_mod.Model(opt, ARM_URDF if robot == "arm" else H30_URDF, regressor_init=False,
              device=cuda_device)
    samples = (_arm_samples(n) if robot == "arm"
               else walking_contact_scenario(m, N=n, seed=1)[0])
    st = _staged(m, samples)
    assert [p["Q"].shape[0] for p in st["parts"]] == rows
    assert all(p["Q"].device.type == "cuda" for p in st["parts"])
    timing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _passes_equal_eager(m, st)
    counters = timing.counters()
    timing.reset()
    assert _graphs_held(m) == len(set(rows))
    assert [d.type for d in m._graphs] == ["cuda"]  # every shard on the one card
    sightings = [7 * rows.count(r) for r in set(rows)]
    assert counters["regressor_graph_captures"] == len(sightings)
    assert counters["regressor_graph_replays"] == sum(
        n - model_mod.GRAPH_CAPTURE_AT for n in sightings)


def test_a_new_friction_threshold_recaptures(cuda_device):
    """Two datasets on one Model with another frictionSignThreshold between
    them: the second is built by a graph of its own, not the stale one."""
    opt = load_config(None, overrides=dict(materializeRegressor=0, verbose=0, gramChunk=4096,
                                           identifyFrictionSimultaneously=1))
    m = model_mod.Model(opt, ARM_URDF, regressor_init=False, device=cuda_device)
    st = _staged(m, _arm_samples(2000, seed=1))
    _passes_equal_eager(m, st)
    assert _graphs_held(m) == 1
    m.opt["frictionSignThreshold"] = 0.5
    st = _staged(m, _arm_samples(2000, seed=2))
    old = [Y for _, Y in m._identified_chunks(st)]  # eager: a new key
    (cache,) = m._graphs.values()
    assert cache.entries[m._graph_key(st["parts"][0]["Q"], None)] == 1  # one eager build
    _passes_equal_eager(m, st)
    assert _graphs_held(m) == 2
    assert torch.equal(old[0], _eager(m, st)[0])
    m.opt["frictionSignThreshold"] = 0.02
    assert not torch.equal(old[0], _eager(m, st)[0])  # the threshold reaches the columns


def test_graph_cache_is_bounded_on_the_card(cuda_device):
    """Six recording lengths on one Model: at most GRAPH_BOUND keys are
    kept, and every build still equals eager."""
    opt = load_config(None, overrides=dict(materializeRegressor=0, verbose=0, gramChunk=4096))
    m = model_mod.Model(opt, ARM_URDF, regressor_init=False, device=cuda_device)
    for n in (500, 600, 700, 800, 900, 1000):
        _passes_equal_eager(m, _staged(m, _arm_samples(n, seed=n)))
        (cache,) = m._graphs.values()
        assert len(cache.entries) <= model_mod.GRAPH_BOUND
    assert [k[0] for k in cache.entries] == [700, 800, 900, 1000]
    assert _graphs_held(m) == 4


def test_streamed_identify_with_graphs_equals_eager(cuda_device, tmp_path, monkeypatch):
    """The benchmark's arm options on one card, three identifications of one
    recording (eager passes; eager, capture and replay; replays only),
    against the same identify with every build eager (the capture replaced
    by the eager build):
    the same Grams bit for bit. The standard parameters and the residual
    within 1e-12 relative: the f64 SDP solve on the card is not bitwise
    reproducible, two eager identifies of the same Grams on an H100 part by
    up to ~3e-15 of max|x|."""
    urdf = str(tmp_path / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    shutil.copy(ARM_URDF + ".regressor.npz", urdf + ".regressor.npz")
    opt = dict(floatingBase=0, simulateTorques=0, useStructuralRegressor=1, randomSamples=600,
               estimateWith="std", materializeRegressor=0, gramChunk=4096,
               constrainToConsistent=1, limitOverallMass=1, limitMassRange=1.0,
               limitMassToApriori=1, limitMassAprioriBoundary=0.3, verbose=0)
    samples = _arm_samples(4096 + 2656, seed=5)
    samples["torques"] *= 0.05
    runs = {}
    for mode in ("eager", "graphs"):
        if mode == "eager":
            monkeypatch.setattr(graphs, "Captured", lambda fn, args: lambda a: fn(*a))
        else:
            monkeypatch.undo()
        idf = Identification(load_config(None, overrides=opt), urdf, device=cuda_device)
        out = []
        for _ in range(3):
            idf.data.init_from_data(dict(samples))
            idf.estimateParameters()
            m = idf.model
            out.append((np.array(m.G_std), np.array(m.g_tau), np.array(m.G_base),
                        np.array(m.xStd), float(idf.res_error)))
        runs[mode] = (idf, out)
    assert _graphs_held(runs["eager"][0].model) == 0
    assert _graphs_held(runs["graphs"][0].model) == 2
    for eager, graphed in zip(runs["eager"][1], runs["graphs"][1]):
        for e, g in zip(eager[:3], graphed[:3]):  # G_std, g_tau, G_base
            np.testing.assert_array_equal(g, e)
        (xe, re), (xg, rg) = eager[3:], graphed[3:]
        assert np.max(np.abs(xg - xe)) <= 1e-12 * np.max(np.abs(xe))
        assert abs(rg - re) <= 1e-12 * abs(re)


# ----------------------------------------------------------------------
# the SDP Newton step replayed from one CUDA graph per solver (conic.py)
# ----------------------------------------------------------------------
ARM_SDP = dict(floatingBase=0, simulateTorques=0, useStructuralRegressor=1, randomSamples=600,
               estimateWith="std", materializeRegressor=0, gramChunk=4096,
               constrainToConsistent=1, limitOverallMass=1, limitMassRange=1.0,
               limitMassToApriori=1, limitMassAprioriBoundary=0.3, verbose=0)
H30_SDP = dict(  # bench.py:90-98, the quadratic CAD regularization
    floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0, limitMassToApriori=1,
    limitMassAprioriBoundary=0.5, cadRegularizationMode="observability",
    useStructuralRegressor=1, randomSamples=2000, materializeRegressor=0, estimateWith="std",
    gramChunk=1024, verbose=0)


def _sdp_identification(robot, device, tmp_path):
    """(Identification, three recordings): the arm at N = 2000 with the
    benchmark's options, or humanoid30 walking at N = 1000 with bench.py's."""
    if robot == "arm":
        urdf = str(tmp_path / "arm.urdf")
        shutil.copy(ARM_URDF, urdf)
        shutil.copy(ARM_URDF + ".regressor.npz", urdf + ".regressor.npz")
        idf = Identification(load_config(None, overrides=ARM_SDP), urdf, device=device)
        recs = [_arm_samples(2000, seed=s) for s in (11, 12, 13)]
        for r in recs:
            r["torques"] *= 0.05
        return idf, recs
    idf = Identification(load_config(None, overrides=H30_SDP), H30_URDF, device=device)
    return idf, [walking_contact_scenario(idf.model, N=1000, seed=s)[0] for s in (11, 12, 13)]


@pytest.fixture
def step_args(cuda_device, tmp_path, monkeypatch):
    """The main solver of the arm's SDP on the card and the (x, t, H, q) of
    every step of its second identification."""
    seen = []
    step = conic.QuadBarrierSolver._step

    def recorded(self, x, t, H, q):
        seen.append((self, (x.clone(), t.clone(), H.clone(), q.clone())))
        return step(self, x, t, H, q)

    monkeypatch.setattr(conic.QuadBarrierSolver, "_step", recorded)
    idf, recs = _sdp_identification("arm", cuda_device, tmp_path)
    for r in recs[:2]:
        seen.clear()
        idf.data.init_from_data(dict(r))
        idf.estimateParameters()
    solver = idf.sdp._last_solver
    return solver, [a for s, a in seen if s is solver]


def test_replayed_newton_step_equals_eager(step_args):
    """Every step of an identification, replayed from one graph captured on
    the first step's inputs, against the eager step on the same (x, t, H,
    q). With deterministic algorithms (the barrier gradient's f64
    `index_add_` then sums in a fixed order) bit for bit; without them the
    atomics may sum in another order under replay than in eager steps,
    which repeat their own bits back to back: x within 1e-14 of max|x|
    (2e-17 measured on an H100), the same accepted step, and the decrement
    within 1e-12, five orders under the tightest stopping tolerance (it is
    -g.dx, a difference of products near convergence: 1.8e-18 measured
    where it read 1.3e-4)."""
    solver, args = step_args
    assert len(args) >= 3 and args[0][1].shape == () and args[0][1].device.type == "cuda"
    n = solver.n
    for deterministic in (True, False):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            graph = graphs.Captured(solver._newton_step, args[0])
            for a in args:
                eager, replay = solver._newton_step(*a), graph(a)
                assert replay.shape == (n + 3,)
                if deterministic:
                    assert torch.equal(replay, eager)
                else:
                    dx = (replay - eager).abs()
                    assert float(dx[:n].max()) <= 1e-14 * float(eager[:n].abs().max())
                    assert float(dx[n]) <= 1e-12  # the decrement, -g.dx
                    assert torch.equal(replay[n + 1:], eager[n + 1:])  # ok, step
        finally:
            torch.use_deterministic_algorithms(False)


def test_newton_graph_runs_without_a_host_sync(step_args):
    """An eager step, the capture and a replay raise nothing under
    set_sync_debug_mode("error"): the step reads nothing from the card on
    the host; the solver's one host read per step comes after it."""
    solver, args = step_args
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver._newton_step(*args[0])
        graph = graphs.Captured(solver._newton_step, args[0])
        graph(args[1])
        with pytest.raises(RuntimeError):  # the mode is on: a 0-d index syncs
            solver._steps[torch.tensor(1, device=solver.device)]
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("robot", ["arm", "h30"])
def test_identify_with_newton_graphs_equals_eager(cuda_device, tmp_path, monkeypatch, robot):
    """Three identifications (the first cold: eager steps, then the capture
    and replays; then replays only) against the same three with every
    Newton step eager: the same status and Newton steps each time, xBase
    within 1e-8 relative."""
    runs = {}
    for mode in ("eager", "graphs"):
        if mode == "eager":
            monkeypatch.setattr(conic, "NEWTON_GRAPH_CAPTURE_AT", 10**9)
        else:
            monkeypatch.undo()
        idf, recs = _sdp_identification(robot, cuda_device, tmp_path)
        timing.reset()
        out = []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for r in recs:
                idf.data.init_from_data(dict(r))
                idf.estimateParameters()
                out.append((idf.sdp.last_status, idf.sdp.last_info["newton_iters"],
                            np.array(idf.model.xBase)))
        runs[mode] = (out, timing.counters())
        timing.reset()
    (eager, c_eager), (graphed, c_graphed) = runs["eager"], runs["graphs"]
    assert c_eager["sdp_newton_graph_replays"] == 0
    assert "sdp_newton_graph_captures" not in c_eager
    assert c_graphed["sdp_newton_graph_captures"] >= 1
    assert c_graphed["sdp_newton_graph_replays"] > c_graphed["sdp_newton_steps"] / 2
    assert c_graphed["sdp_newton_steps"] == c_eager["sdp_newton_steps"]
    for (se, ie, xe), (sg, ig, xg) in zip(eager, graphed):
        assert sg == se and se.startswith("optimal") and ig == ie
        assert np.max(np.abs(xg - xe)) <= 1e-8 * np.max(np.abs(xe))
