"""Mean per identification of the regressor and Gram stage
(`Model.computeRegressors`, the contact J^T w inside it), in ms: the
benchmark's span around that call in `estimateParameters`, extended to the
end of the last device operation launched inside it, in the traced window."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("units"):
        return None
    s = tr.span_seconds("regressor_gram", "estimateParameters")
    return 1e3 * s / rec["units"] if s > 0 else None
