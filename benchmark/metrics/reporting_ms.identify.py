"""Mean per identification of the reporting pass after the solve
(`Model.residual_stats`, `prefetch_contractions`, `estimateRegressorTorques`
as `estimateParameters` calls them; not the calls inside the least squares),
in ms: the benchmark's spans around those calls, each extended to the end
of the last device operation launched inside it, in the traced window."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("units"):
        return None
    s = tr.span_seconds("reporting", "estimateParameters")
    return 1e3 * s / rec["units"] if s > 0 else None
