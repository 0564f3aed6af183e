"""The port's tracer (`flobaroid_tpu_torch/utils/timing.py`): off, it is one
check and a shared no-op; under torch.profiler, spans nest with their
parent and root ids, lie on the profiler's clock, and count the arm
identify's regressor rows and SDP Newton steps. The identify runs the
benchmark's arm options (streamed Grams, measured torques, the SDP) on 2000
random in-limit states on the CPU."""

import os
import shutil
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flobaroid_tpu_torch.identification.identifier import Identification
from flobaroid_tpu_torch.utils import timing
from flobaroid_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
ARM = dict(
    floatingBase=0, simulateTorques=0, useStructuralRegressor=1, randomSamples=600,
    estimateWith="std", materializeRegressor=0, gramChunk=4096, constrainToConsistent=1,
    limitOverallMass=1, limitMassRange=1.0, limitMassToApriori=1,
    limitMassAprioriBoundary=0.3, verbose=0,
)
N = 2000
STAGES = ["regressor_gram", "ols_wls", "sdp", "reporting"]


def _arm_samples(idf, n, seed):
    """n random in-limit states with the URDF's torques plus 0.05 Nm noise."""
    tree = idf.model.tree
    lims = tree.joint_limits()
    names = tree.dof_names
    lo = np.array([lims[j]["lower"] for j in names])
    hi = np.array([lims[j]["upper"] for j in names])
    vl = np.array([min(lims[j]["velocity"], 10.0) for j in names])
    rng = np.random.default_rng(seed)
    nd = len(names)
    s = dict(positions=lo + (hi - lo) * rng.random((n, nd)),
             velocities=(rng.random((n, nd)) - 0.5) * 2 * vl,
             accelerations=(rng.random((n, nd)) - 0.5) * 2 * np.pi,
             torques=np.zeros((n, nd)), times=np.arange(n) / 200.0, frequency=np.array(200.0))
    tau = idf.model.simulate_dynamics(s, np.arange(n))
    s["torques"] = tau + 0.05 * rng.standard_normal(tau.shape)
    return s


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tracing_arm")
    for f in (ARM_URDF, ARM_URDF + ".regressor.npz"):
        shutil.copy(f, d)
    idf = Identification(load_config(None, overrides=dict(ARM)),
                         str(d / "sevenlink_arm.urdf"), device="cpu")
    return idf, _arm_samples(idf, N, seed=1)


class _Clock:
    """time as the tracer sees it, counting the reads of each clock."""

    def __init__(self):
        self.reads = {"perf_counter": 0, "time_ns": 0}

    def perf_counter(self):
        self.reads["perf_counter"] += 1
        return 0.0

    def time_ns(self):
        self.reads["time_ns"] += 1
        return 0


@pytest.fixture(scope="module")
def traced_arm(arm):
    """One untraced identify, then one under torch.profiler: the records,
    counters and profiler events of the second."""
    idf, samples = arm
    idf.data.init_from_data(dict(samples))
    idf.estimateParameters()
    timing.reset()
    idf.data.init_from_data(dict(samples))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idf.estimateParameters()
    out = types.SimpleNamespace(idf=idf, records=timing.records(), counters=timing.counters(),
                                events=list(prof.profiler.kineto_results.events()))
    timing.reset()
    return out


def test_the_span_is_a_shared_noop_without_a_profiler(arm, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert timing.span("a") is timing.span("b", N=3) is timing._OFF
    timing.reset()
    timing.count("x", 5)
    assert timing.records() == [] and timing.counters() == {}
    idf, samples = arm
    idf.data.init_from_data(dict(samples))
    clock = _Clock()
    monkeypatch.setattr(timing, "time", clock)
    idf.estimateParameters()
    monkeypatch.undo()
    assert list(idf.stage_times) == STAGES
    assert timing.records() == [] and timing.counters() == {}
    # one perf_counter read at the start and one at each stage's end, as
    # the stage marks before the tracer; no other clock
    assert clock.reads == {"perf_counter": 1 + len(STAGES), "time_ns": 0}


def test_spans_nest_with_parent_and_root_ids():
    @timing.traced("leaf")
    def leaf():
        timing.count("n", 2)
        return 7

    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("root", N=10):
            with timing.span("mid"):
                assert leaf() == 7
                timing.count("n")
            assert timing.host_read(torch.ones(2)).sum() == 2
        with timing.span("root2"):
            pass
    recs = {r.name: r for r in timing.records()}
    assert [r.name for r in timing.records()] == ["root", "mid", "leaf", "host_read", "root2"]
    root, mid, leaf_, read, root2 = (recs[k] for k in ("root", "mid", "leaf", "host_read", "root2"))
    assert root.parent is None and root.root == root.id and root.attrs == {"N": 10}
    assert mid.parent == root.id and leaf_.parent == mid.id and read.parent == root.id
    assert {mid.root, leaf_.root, read.root} == {root.id}
    assert root2.parent is None and root2.root == root2.id != root.id
    # a counter goes to the innermost open span and to the totals
    assert leaf_.attrs == {"n": 2} and mid.attrs == {"n": 1} and read.attrs == {"host_reads": 1}
    assert timing.counters() == {"n": 3, "host_reads": 1}
    for r in timing.records():
        assert r.start_ns <= r.end_ns
    assert root.start_ns <= mid.start_ns <= leaf_.start_ns <= leaf_.end_ns <= mid.end_ns <= root.end_ns
    timing.reset()
    assert timing.records() == [] and timing.counters() == {}


def test_records_past_the_bound_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(timing, "BOUND", 2)
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with timing.span("s"):
                timing.count("c")
    assert len(timing.records()) == 2
    assert timing.counters() == {"c": 5, "dropped": 3}
    timing.reset()


def test_records_lie_on_the_profilers_clock(traced_arm):
    twins = {}
    for e in traced_arm.events:
        if e.name().startswith(timing.PREFIX):
            twins.setdefault(e.name()[len(timing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    by_name = {}
    for r in traced_arm.records:
        by_name.setdefault(r.name, []).append(r)
    assert sorted(by_name) == sorted(twins)
    for name, recs in by_name.items():
        ends = sorted(twins[name])
        assert len(ends) == len(recs)
        for r, (s, e) in zip(sorted(recs, key=lambda r: r.start_ns), ends):
            assert abs(r.start_ns - s) < 1_000_000 and abs(r.end_ns - e) < 1_000_000, (name, r, s, e)


def test_the_arm_identify_counts_its_passes_and_newton_steps(traced_arm):
    recs, counters, idf = traced_arm.records, traced_arm.counters, traced_arm.idf
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["identify"] and roots[0].attrs["N"] == N
    assert all(r.root == roots[0].id for r in recs)
    names = {r.name for r in recs}
    assert {f"identify/{s}" for s in STAGES} | {
        "regressor/build", "gram", "host_read", "sdp/setup", "sdp/phase1", "sdp/newton_step",
        "reporting/residual_stats", "reporting/contract", "reporting/torques"} == names - {"identify"}
    # the Gram pass, the least squares' residual pass, the reporting contraction
    assert counters["regressor_rows"] == 3 * N
    assert counters["sdp_newton_steps"] >= idf.sdp.last_info["newton_iters"] > 0
    assert counters["sdp_newton_steps"] == sum(r.name == "sdp/newton_step" for r in recs)
    assert counters["host_reads"] == sum(r.name == "host_read" for r in recs)
    ids = {r.id: r for r in recs}
    ols = next(r for r in recs if r.name == "identify/ols_wls")
    stats = next(r for r in recs if r.name == "reporting/residual_stats")
    while stats.parent != ols.id:  # the OLS step's residual pass is under its stage
        stats = ids[stats.parent]
    assert list(idf.stage_times) == STAGES
