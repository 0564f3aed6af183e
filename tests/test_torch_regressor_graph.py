"""The streamed regressor build's CUDA-graph cache (`utils/graphs.py`,
`Model._identified_chunks`) on the CPU: CPU tensors keep the eager build;
the cache key holds everything the captured build reads as a constant; the
cache runs a key eager until its `GRAPH_CAPTURE_AT`-th call, captures, then
replays, keeps at most its bound per device, least recently used evicted
first. The capture is a stub here; the graphs themselves run in
tests/test_torch_cuda.py on the card."""

import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flobaroid_tpu_torch import model as model_mod
from flobaroid_tpu_torch.data import Data
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.parallel.mesh import Mesh
from flobaroid_tpu_torch.utils import graphs, timing
from flobaroid_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
ARM = dict(floatingBase=0, useStructuralRegressor=1, randomSamples=600, materializeRegressor=0,
           gramChunk=128, verbose=0)
N = 300  # pieces of 128, 128 and 44 rows


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_regressor_graph")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz"):
        shutil.copy(f, d)
    m = Model(load_config(None, overrides=dict(ARM)), str(d / "sevenlink_arm.urdf"), device="cpu")
    rng = np.random.default_rng(3)
    s = dict(positions=rng.uniform(-1.5, 1.5, (N, 7)), velocities=rng.standard_normal((N, 7)),
             accelerations=rng.standard_normal((N, 7)) * 3, torques=rng.standard_normal((N, 7)),
             times=np.arange(N) / 200.0, frequency=np.array(200.0))
    data = Data(m.opt)
    data.init_from_data(s)
    return m, data


@pytest.fixture
def captures(monkeypatch):
    """`graphs.Captured` replaced by a stub whose calls run the function
    eagerly; the list of the first args of every capture."""
    made = []

    class Stub:
        def __init__(self, fn, args):
            self.fn = fn
            made.append(args[0])

        def __call__(self, args):
            return self.fn(*args)

    monkeypatch.setattr(graphs, "Captured", Stub)
    return made


def test_cpu_tensors_keep_the_eager_build(arm):
    m, data = arm
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m.computeRegressors(data)  # the Gram pass
        x = m.xStdModel[m.identified_params]
        m.residual_stats([x])
        m.contract_identified(x)
    counters, recs = timing.counters(), timing.records()
    timing.reset()
    builds = [r for r in recs if r.name == "regressor/build"]
    assert len(builds) == 3 * 3  # three pieces in each of three passes
    assert counters["regressor_rows"] == 3 * N
    assert counters["regressor_graph_replays"] == 0
    assert "regressor_graph_captures" not in counters
    assert all(r.attrs["regressor_graph_replays"] == 0 for r in builds)
    assert not m._graphs
    # every piece is the eager build of its staged state
    for part, (sl, Y) in zip(m._staged["parts"], m._identified_chunks(m._staged)):
        assert sl == part["sl"]
        args = [part[k] for k in ("Q", "V", "A", "BR", "BV", "BA", "vsig")]
        assert torch.equal(Y, m._chunk_build(*args))


OPTIONS = [("identifyGravityParamsOnly", 1), ("identifyFrictionSimultaneously", 1),
           ("identifySymmetricVelFriction", 0), ("stribeckVelocity", 0.1),
           ("frictionSignThreshold", 0.05)]


@pytest.mark.parametrize("name,value", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_the_graph_key_changes_with_each_option_it_reads(arm, name, value, monkeypatch):
    m, _ = arm
    Q = torch.zeros((128, 7))
    before = m._graph_key(Q, None)
    monkeypatch.setitem(m.opt, name, value)
    assert m._graph_key(Q, None) != before
    monkeypatch.undo()
    assert m._graph_key(Q, None) == before


@pytest.mark.parametrize("change", ["rows", "base", "dtype"])
def test_the_graph_key_changes_with_the_piece(arm, change):
    m, _ = arm
    Q, BR = torch.zeros((128, 7)), None
    before = m._graph_key(Q, BR)
    if change == "rows":
        Q = torch.zeros((44, 7))
    elif change == "base":
        BR = torch.eye(3).expand(128, 3, 3)
    else:
        Q = Q.double()
    assert m._graph_key(Q, BR) != before
    assert m._graph_key(torch.ones((128, 7)), None) == before  # values are not in the key


def test_a_key_runs_eager_then_captures_then_replays(captures):
    # one identification with the a-priori simulation builds a piece four times
    assert model_mod.GRAPH_CAPTURE_AT == 5
    cache = graphs.GraphCache(model_mod.GRAPH_BOUND, model_mod.GRAPH_CAPTURE_AT)
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    got = [cache("k", fn, (torch.tensor(float(i)),)) for i in range(7)]
    assert [how for _, how in got] == ["eager"] * 4 + ["capture", "replay", "replay"]
    assert [float(y) for y, _ in got] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    assert len(captures) == 1 and len(calls) == 7


def test_the_cache_keeps_its_bound_and_evicts_the_least_recently_used(captures):
    assert model_mod.GRAPH_BOUND == 4
    cache = graphs.GraphCache(model_mod.GRAPH_BOUND, 2)

    def run(key):
        return cache(key, lambda x: x, (torch.zeros(1),))[1]

    for k in "abcd":
        assert run(k) == "eager"
    assert run("a") == "capture"  # "a" is now the most recently used
    assert run("e") == "eager"  # evicts "b", the least recently used
    assert list(cache.entries) == ["c", "d", "a", "e"]
    assert len(cache.entries) == 4
    assert run("b") == "eager"  # seen again from scratch; evicts "c"
    assert run("a") == "replay"  # the captured graph survived
    assert list(cache.entries) == ["d", "e", "b", "a"]
    for k in "fghij":
        run(k)
        assert len(cache.entries) <= 4
    assert "a" not in cache.entries and run("a") == "eager"  # evicted graphs are dropped
    assert len(captures) == 1


def test_sharded_pieces_keep_their_graphs(arm, captures, monkeypatch):
    """`shardSamples` 4 on four cards: N = 60 000 in chunks of 4096 makes
    14 full chunks of four 1024-row shards and a 2656-row tail of four
    664-row shards, in the order `_sample_pieces` gives them. Nine passes
    (three identifications) through the model's per-device caches: each
    device captures its full-chunk shard in the first pass and its tail
    shard in the fifth, once each, and replays both from then on."""
    m, _ = arm
    cards = tuple(torch.device("cuda", i) for i in range(4))
    monkeypatch.setitem(m.opt, "shardSamples", 4)
    monkeypatch.setitem(m.opt, "gramChunk", 4096)
    monkeypatch.setitem(m._meshes, 4, Mesh(cards, "samples"))
    pieces = m._sample_pieces(60000)
    assert len(pieces) == 15 * 4
    assert [dev for _, dev in pieces[:8]] == list(cards) * 2
    try:
        hows = []  # per pass: (device index, rows) -> how each of its builds ran
        for _ in range(9):
            seen = {}
            for sl, dev in pieces:
                Q = torch.zeros((sl.stop - sl.start, 7))
                how = m._graphs[dev](m._graph_key(Q, None), lambda q: q, (Q,))[1]
                seen.setdefault((dev.index, Q.shape[0]), []).append(how)
            hows.append(seen)
        assert len(captures) == 8
        for i in range(4):
            full, tail = [p[(i, 1024)] for p in hows], [p[(i, 664)] for p in hows]
            assert full[0] == ["eager"] * 4 + ["capture"] + ["replay"] * 9
            assert all(p == ["replay"] * 14 for p in full[1:])
            assert tail[:4] == [["eager"]] * 4 and tail[4] == ["capture"]
            assert tail[5:] == [["replay"]] * 4
            assert len(m._graphs[cards[i]].entries) == 2
        assert list(m._graphs) == list(cards)
    finally:
        m._graphs.clear()
