"""Share of the program's regressor builds served by the replay of a CUDA
graph (counter `regressor_graph_replays`, 1 or 0 in each `regressor/build`
span of `Model._identified_chunks`) over those builds, in the traced window.
A program without the graphed build keeps no such counter and reads
nothing."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None or "regressor_graph_replays" not in p.counter_names:
        return None
    builds = len(p.spans("regressor/build"))
    return p.counters()["regressor_graph_replays"] / builds if builds else None
