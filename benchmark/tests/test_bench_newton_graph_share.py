"""The reader of `sdp_newton_graph_share.identify` on the synthetic window and
records of test_bench_program_trace: the replays of a CUDA graph over the
window's SDP Newton steps."""

import os

import pytest
from test_bench_program_trace import _records, _trace

from benchmark.harness import manifest, program_trace
from flobaroid_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("case,share", [("replays", 0.5), ("all replays", 1.0),
                                        ("no replays", 0.0), ("no counter", None)])
def test_the_newton_graph_share_reader(monkeypatch, case, share):
    """Replays over the window's Newton steps; 0 where every step ran eager;
    nothing from a program that keeps no replay counter (one without the
    graphed step). A step of the root that outlives the window does not
    count."""
    recs = _records() + [timing.Record(9, 7, 7, "sdp/newton_step", 7, 975, 985,
                                       {"sdp_newton_steps": 1})]
    totals = {"regressor_rows": 300, "sdp_newton_steps": 3}
    if case != "no counter":
        steps = (recs[2], recs[3], recs[8])
        replays = {"replays": (0, 1, 1), "all replays": (1, 1, 1), "no replays": (0, 0, 0)}[case]
        for r, n in zip(steps, replays):
            r.attrs["sdp_newton_graph_replays"] = n
        totals["sdp_newton_graph_replays"] = sum(replays)
    monkeypatch.setattr(timing, "records", lambda: recs)
    monkeypatch.setattr(timing, "counters", lambda: totals)
    program_trace.joined.cache_clear()
    rec = {"trace": _trace(), "units": 1}
    got = manifest.reader(REPO, "sdp_newton_graph_share.identify").read(rec)
    program_trace.joined.cache_clear()
    assert got == share
