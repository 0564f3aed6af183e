"""The program's own spans and counters (`flobaroid_tpu_torch.utils.timing`,
recorded while the profiler records) joined with a traced window's Trace.

A device operation belongs to a program span when the runtime call that
launched it was made, on the benchmark's main thread (`Trace.main_thread()`),
while that span was the innermost program span open there. Only the spans
of roots (spans with no parent, `identify` per identification) that opened
and closed inside the window count. Where the program keeps no records (a
program without the tracer, or none inside the window), `joined` gives None
and every reader of it leaves its metric out.

    python3 -m benchmark.harness.program_trace --workload <cell> --seed <n> [--seconds 15]

traces one window of a cell as a traced benchmark run does and prints, as
one JSON line, the device idle seconds of the window by innermost program
span, each span's seconds and the counters, per identification.
"""

from __future__ import annotations

import os

if __name__ == "__main__":  # as benchmark/run.py, before numpy and torch load
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_var] = "1"

import bisect  # noqa: E402
import functools  # noqa: E402
from collections import defaultdict  # noqa: E402

from .trace import _segments  # noqa: E402

OUTSIDE = "outside program spans"


def _union(intervals):
    """Sorted disjoint union of [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Program:
    """The program's records of one traced window, joined with its Trace."""

    def __init__(self, tr, records, totals):
        self.tr = tr
        self.dropped = int(totals.get("dropped", 0))  # records past the program's bound
        closed = [r for r in records
                  if r.end_ns is not None and r.start_ns >= tr.t0 and r.end_ns <= tr.t1]
        self.roots = [r for r in closed if r.parent is None]
        ids = {r.id for r in self.roots}
        self.records = sorted((r for r in closed if r.root in ids), key=lambda r: r.start_ns)
        self.counter_names = sorted(k for k in totals if k != "dropped")
        by_thread = defaultdict(int)
        for r in self.records:
            by_thread[r.thread] += 1
        thread = max(by_thread, key=by_thread.get) if by_thread else None
        main = [i for i, r in enumerate(self.records) if r.thread == thread]
        self._seg = _segments([(self.records[i].start_ns, self.records[i].end_ns, i) for i in main])
        # each span's end extended to the end of the device work launched
        # inside it or inside a span nested in it
        self._ext = [r.end_ns for r in self.records]
        host = tr.main_thread()
        for (_, end, _), src in zip(tr.device, tr._launch):
            if src is not None and src[0] == host:
                i = self._innermost(src[1])
                if i is not None:
                    self._ext[i] = max(self._ext[i], end)
        self._by_id = {r.id: r for r in self.records}
        index = {r.id: i for i, r in enumerate(self.records)}
        for i in range(len(self.records) - 1, -1, -1):  # children open after their parents
            p = index.get(self.records[i].parent)
            if p is not None:
                self._ext[p] = max(self._ext[p], self._ext[i])

    def _innermost(self, t):
        times, idx = self._seg
        k = bisect.bisect_right(times, t) - 1
        return idx[k] if k >= 0 else None

    @property
    def identifications(self) -> int:
        return len(self.roots)

    @property
    def samples(self) -> int:
        """Sum of the roots' N (samples identified)."""
        return sum(int(r.attrs.get("N", 0)) for r in self.roots)

    def spans(self, name: str) -> list:
        return [r for r in self.records if r.name == name]

    def span_seconds(self, name: str) -> float:
        """Seconds in the spans `name`, each extended to the end of the
        device work launched inside it; overlaps count once."""
        return sum(e - s for s, e in _union(
            (r.start_ns, self._ext[i]) for i, r in enumerate(self.records) if r.name == name)) / 1e9

    def host_seconds(self, name: str) -> float:
        """Seconds in the spans `name` on the host (not extended)."""
        return sum(e - s for s, e in _union((r.start_ns, r.end_ns) for r in self.spans(name))) / 1e9

    def idle_seconds_in(self, name: str) -> float:
        """Device idle seconds while a span `name` is open on the host."""
        spans = _union((r.start_ns, r.end_ns) for r in self.spans(name))
        return (sum(e - s for s, e in spans) - _overlap(spans, self.tr.busy_intervals())) / 1e9

    def counters(self) -> dict:
        """Each counter's sum over the window's records."""
        return {k: sum(r.attrs.get(k, 0) for r in self.records) for k in self.counter_names}

    def stage(self, i: int) -> str:
        """Name of the child of its root that record i is in (itself if it
        is one): `identify/<stage>` for an identification's spans."""
        r = self.records[i]
        while r.parent is not None and r.parent != r.root:
            r = self._by_id[r.parent]
        return r.name

    def idle_by_span(self, by_stage: bool = False) -> list:
        """The window's device idle seconds, split by the innermost program
        span open on the host over each part of each gap (with by_stage,
        by "<stage> > <innermost span>"), largest first."""
        def label(i):
            if i is None:
                return OUTSIDE
            name = self.records[i].name
            return f"{self.stage(i)} > {name}" if by_stage and self.stage(i) != name else name

        times, idx = self._seg
        by = defaultdict(int)
        prev = self.tr.t0
        for s, e in self.tr.busy_intervals() + [[self.tr.t1, self.tr.t1]]:
            t = prev
            k = bisect.bisect_right(times, t) - 1
            while t < s:  # the gap [prev, s), cut where the innermost span changes
                nxt = times[k + 1] if k + 1 < len(times) else s
                end = min(s, nxt)
                by[label(idx[k] if k >= 0 else None)] += end - t
                t, k = end, k + 1
            prev = max(prev, e)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])]


@functools.lru_cache(maxsize=1)
def joined(tr) -> Program | None:
    """The program's records of the traced window `tr`, or None where there
    are none (the program has no tracer, or recorded nothing in it)."""
    if tr is None:
        return None
    try:
        from flobaroid_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "records"):
        return None
    p = Program(tr, timing.records(), timing.counters())
    return p if p.records else None


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import sys
    import tempfile

    import torch

    from . import device as card, manifest, runner, trace, window

    ap = argparse.ArgumentParser(description="Device idle time of one traced window of a cell, "
                                             "by innermost program span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=runner.TRACED_S)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    man = manifest.load(root)
    cell = manifest.workload(man, a.workload)
    spec = manifest.traffic(root, cell["traffic"])
    kind = manifest.kind(root, spec)
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        c = kind.Cell(root, manifest.config(root, man, cell["config"]), spec, a.seed, a.device,
                      workdir)
        for _ in c.setup():
            pass
        undo = [runner._wrap(*s) for s in c.spans()]
        try:
            with trace.profiled(True) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    win = window.run(c.unit, a.seconds)
        finally:
            for u in undo:
                u()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tr = prof.trace
    p = joined(tr)
    if p is None:
        print("the program recorded no spans in the window", file=sys.stderr)
        return 1
    n = p.identifications
    names = sorted({r.name for r in p.records})
    print(json.dumps({
        "workload": a.workload, "seed": a.seed,
        "card": card.name_and_power_limit() if a.device == "cuda" else "cpu",
        "window_s": tr.window_s, "busy_s": tr.busy_s, "units": len(win.walls),
        "identifications": n, "samples_per_identification": p.samples / n,
        "idle_by_program_span_s": p.idle_by_span(),
        "idle_by_stage_and_span_s": p.idle_by_span(by_stage=True),
        "span_ms_per_identification": {k: 1e3 * p.span_seconds(k) / n for k in names},
        "host_ms_per_identification": {k: 1e3 * p.host_seconds(k) / n for k in names},
        "spans_per_identification": {k: len(p.spans(k)) / n for k in names},
        "counters_per_identification": {k: v / n for k, v in p.counters().items()},
        "dropped_records": p.dropped,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
