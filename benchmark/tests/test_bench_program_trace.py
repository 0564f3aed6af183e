"""The join of the program's own spans with a traced window
(`benchmark/harness/program_trace.py`) and the readers of its five metrics,
on a synthetic trace and records with known launches, gaps and nesting."""

import os

import pytest
from test_bench_harness import Ev

from benchmark.harness import manifest, program_trace, trace
from flobaroid_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
METRICS = ["regressor_passes.identify", "regressor_build_ms.identify",
           "sdp_newton_steps.identify", "sdp_newton_ms.identify", "sdp_newton_idle_pct.identify"]


def _trace():
    # window 0-1000 ns; launches on the benchmark's thread at 120, 510, 720
    # and 965; kernels 150-250, 550-650, 730-800, 970-990
    return trace.Trace([
        Ev("bench/window", 0, 1000, annotation=True),
        Ev("bench/estimateParameters", 0, 1000, annotation=True),
        Ev("cudaLaunchKernel", 120, 5, corr=1),
        Ev("cudaLaunchKernel", 510, 5, corr=2),
        Ev("cudaLaunchKernel", 720, 5, corr=3),
        Ev("cudaLaunchKernel", 965, 5, corr=5),
        Ev("k1", 150, 100, device=True, corr=1),
        Ev("k2", 550, 100, device=True, corr=2),
        Ev("k3", 730, 70, device=True, corr=3),
        Ev("k5", 970, 20, device=True, corr=5),
    ])


def _records():
    # one identification 50-900 (N = 100): its SDP stage 100-400 with Newton
    # steps 110-200 (launches k1) and 300-390, regressor builds 500-600
    # (k2) and 700-760 (k3); a second root opens at 950 and closes after
    # the window, so neither it nor its build (k5) counts
    R = timing.Record
    return [
        R(1, None, 1, "identify", 7, 50, 900, {"N": 100}),
        R(2, 1, 1, "identify/sdp", 7, 100, 400, {}),
        R(3, 2, 1, "sdp/newton_step", 7, 110, 200, {"sdp_newton_steps": 1}),
        R(4, 2, 1, "sdp/newton_step", 7, 300, 390, {"sdp_newton_steps": 1}),
        R(5, 1, 1, "regressor/build", 7, 500, 600, {"regressor_rows": 100}),
        R(6, 1, 1, "regressor/build", 7, 700, 760, {"regressor_rows": 100}),
        R(7, None, 7, "identify", 7, 950, 1100, {"N": 100}),
        R(8, 7, 7, "regressor/build", 7, 960, 970, {"regressor_rows": 100}),
    ]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(timing, "records", _records)
    monkeypatch.setattr(timing, "counters", lambda: {"regressor_rows": 300, "sdp_newton_steps": 2})
    program_trace.joined.cache_clear()
    yield
    program_trace.joined.cache_clear()


def test_spans_extend_to_the_device_work_they_launched(program):
    p = program_trace.joined(_trace())
    assert p.identifications == 1 and p.samples == 100
    assert p.counters() == {"regressor_rows": 200, "sdp_newton_steps": 2}
    # builds 500-650 and 700-800; steps 110-250 and 300-390
    assert p.span_seconds("regressor/build") == pytest.approx(250e-9)
    assert p.span_seconds("sdp/newton_step") == pytest.approx(230e-9)
    assert p.span_seconds("identify/sdp") == pytest.approx(300e-9)
    assert p.span_seconds("identify") == pytest.approx(850e-9)
    assert p.host_seconds("sdp/newton_step") == pytest.approx(180e-9)


def test_idle_by_innermost_program_span(program):
    p = program_trace.joined(_trace())
    # gaps 0-150, 250-550, 650-730, 800-970, 990-1000 (busy 290 of 1000)
    assert dict(p.idle_by_span()) == pytest.approx({
        "outside program spans": 130e-9, "identify": 300e-9, "identify/sdp": 70e-9,
        "sdp/newton_step": 130e-9, "regressor/build": 80e-9})
    assert p.idle_seconds_in("sdp/newton_step") == pytest.approx(130e-9)
    assert dict(p.idle_by_span(by_stage=True)) == pytest.approx({
        "outside program spans": 130e-9, "identify": 300e-9, "identify/sdp": 70e-9,
        "identify/sdp > sdp/newton_step": 130e-9, "regressor/build": 80e-9})


def test_the_readers(program):
    rec = {"trace": _trace(), "units": 1}
    got = {m: manifest.reader(REPO, m).read(rec) for m in METRICS}
    assert got == pytest.approx({
        "regressor_passes.identify": 2.0, "regressor_build_ms.identify": 250e-6,
        "sdp_newton_steps.identify": 2.0, "sdp_newton_ms.identify": 115e-6,
        "sdp_newton_idle_pct.identify": 100 * 130 / 180})


@pytest.mark.parametrize("case", ["no records", "no tracer", "no trace"])
def test_a_reader_finds_nothing_without_program_records(monkeypatch, case):
    if case == "no records":
        monkeypatch.setattr(timing, "records", lambda: [])
    elif case == "no tracer":  # a program before the tracer
        monkeypatch.delattr(timing, "records")
    program_trace.joined.cache_clear()
    rec = {"trace": None if case == "no trace" else _trace(), "units": 1}
    assert all(manifest.reader(REPO, m).read(rec) is None for m in METRICS)
    program_trace.joined.cache_clear()
