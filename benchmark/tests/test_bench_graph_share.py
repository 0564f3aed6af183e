"""The reader of `regressor_graph_share.identify` on the synthetic window and
records of test_bench_program_trace: the replays of a CUDA graph over the
window's regressor builds."""

import os

import pytest
from test_bench_program_trace import _records, _trace

from benchmark.harness import manifest, program_trace
from flobaroid_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("case,share", [("replays", 0.5), ("no replays", 0.0),
                                        ("no counter", None)])
def test_the_graph_share_reader(monkeypatch, case, share):
    """Replays over the window's builds; 0 where every build ran eager; nothing
    from a program that keeps no replay counter (one without the graphs). The
    build of the root that outlives the window (record 8) does not count."""
    recs = _records()
    totals = {"regressor_rows": 300, "sdp_newton_steps": 2}
    if case != "no counter":
        builds = (recs[4], recs[5], recs[7])
        for r, n in zip(builds, (0, 1, 1) if case == "replays" else (0, 0, 0)):
            r.attrs["regressor_graph_replays"] = n
        totals["regressor_graph_replays"] = sum(r.attrs["regressor_graph_replays"] for r in builds)
    monkeypatch.setattr(timing, "records", lambda: recs)
    monkeypatch.setattr(timing, "counters", lambda: totals)
    program_trace.joined.cache_clear()
    rec = {"trace": _trace(), "units": 1}
    got = manifest.reader(REPO, "regressor_graph_share.identify").read(rec)
    program_trace.joined.cache_clear()
    assert got == share
