"""Mean per identification of the program's regressor builds (span
`regressor/build`: `engine.regressor_batch` and the identified columns of
each chunk, in every pass), in ms: the spans, each extended to the end of
the device work launched inside it, overlaps once, in the traced window."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None or not p.spans("regressor/build"):
        return None
    return 1e3 * p.span_seconds("regressor/build") / p.identifications
