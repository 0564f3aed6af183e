"""Share of the host time of the SDP's Newton steps (spans `sdp/newton_step`)
in which no operation ran on the device, in %, in the traced window."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None:
        return None
    host = p.host_seconds("sdp/newton_step")
    return 100.0 * p.idle_seconds_in("sdp/newton_step") / host if host > 0 else None
