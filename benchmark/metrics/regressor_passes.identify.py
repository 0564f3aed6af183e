"""Regressor passes per identification: the rows the program's regressor
builds made (counter `regressor_rows`, in `Model._identified_chunks`) over
the samples identified (the `N` of each `identify` root span), in the
traced window. The Gram pass, the least squares' residual pass and the
reporting contraction each build every chunk once."""

from benchmark.harness import program_trace


def read(rec):
    p = program_trace.joined(rec.get("trace"))
    if p is None or not p.samples:
        return None
    return p.counters().get("regressor_rows", 0) / p.samples
