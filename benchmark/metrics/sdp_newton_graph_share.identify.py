"""Share of the program's SDP Newton steps served by the replay of a CUDA
graph (counter `sdp_newton_graph_replays`, 1 or 0 in each `sdp/newton_step`
span of `conic._newton_run`) over those steps, in the traced window. A
program without the graphed step keeps no such counter and reads nothing."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None or "sdp_newton_graph_replays" not in p.counter_names:
        return None
    steps = len(p.spans("sdp/newton_step"))
    return p.counters()["sdp_newton_graph_replays"] / steps if steps else None
