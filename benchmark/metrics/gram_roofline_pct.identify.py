"""Share of its roofline that the Gram site reaches: the least time of the
Gram work the identifications in the traced window needed (counted by the
benchmark from N, gramChunk, the output rows and the columns), over the
device time of every operation launched inside the toolkit's Gram entry
`ops/gram.py::gram_batched`, in %."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("units"):
        return None
    device_s = tr.device_seconds_in("gram_batched")
    if device_s <= 0:
        return None
    return 100.0 * rec["units"] * rec["gram_bound_s_per_unit"] / device_s
