"""Mean per identification of the SDP stage (`SDP.initSDP_LMIs` and
`identifyFeasibleStandardParameters`), in ms: the benchmark's spans around
those calls in `estimateParameters`, each extended to the end of the last
device operation launched inside it, in the traced window."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("units"):
        return None
    s = tr.span_seconds("sdp", "estimateParameters")
    return 1e3 * s / rec["units"] if s > 0 else None
