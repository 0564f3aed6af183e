"""Mean time of one SDP Newton step (span `sdp/newton_step`: the step's
direction, line search and its one host read), in ms: the steps' spans,
each extended to the end of the device work launched inside it, overlaps
once, over the number of steps, in the traced window."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None:
        return None
    steps = p.spans("sdp/newton_step")
    return 1e3 * p.span_seconds("sdp/newton_step") / len(steps) if steps else None
