"""SDP Newton steps per identification (counter `sdp_newton_steps`, one per
step of `conic._newton_run`: phase I, the barrier ladder, the polish and
the certification), in the traced window."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None:
        return None
    steps = p.counters().get("sdp_newton_steps", 0)
    return steps / p.identifications if steps else None
