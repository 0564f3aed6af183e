"""Reading a torch.profiler window: device busy time, the device time of
kernels launched inside a host span, the time a layer's spans take with
the device work they launched, and the breakdown of a traced run.

Spans are `torch.profiler.record_function` ranges whose names start with
SPAN (the benchmark's own spans). A device operation belongs to a span
when the CUDA runtime call that launched it (same correlation id) was
made while that span was the innermost open one on its thread. The events are read from the
profiler's kineto results directly, without building its per-event
Python objects, which a window of a million kernels makes slow.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
import types
from collections import defaultdict

import torch

SPAN = "bench/"
WINDOW = SPAN + "window"


def _segments(spans):
    """Piecewise-constant innermost span name of properly nested spans:
    (times, names) with names[i] open from times[i] to times[i + 1]."""
    times, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            names.append(stack[-1][2] if stack else None)

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        stack.append((s, e, n))
        times.append(s)
        names.append(n)
    close_until(float("inf"))
    return times, names


def span(name: str):
    return torch.profiler.record_function(SPAN + name)


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler session over the block (CPU and CUDA activity),
    yielding a holder whose .trace is a Trace after the block."""
    holder = types.SimpleNamespace(trace=None)
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
        t = time.perf_counter()
    t_stop = time.perf_counter()
    holder.trace = Trace(prof.profiler.kineto_results.events())
    print(f"trace: profiler stop {t_stop - t:.3f} s, read {time.perf_counter() - t_stop:.3f} s, "
          f"{len(holder.trace.device)} device operations", file=sys.stderr, flush=True)


class Trace:
    """Device intervals and host spans of one traced window, in ns."""

    def __init__(self, events):
        self.device = []  # (start, end, name)
        self.spans = defaultdict(list)  # thread -> [(start, end, name)]
        launch = {}  # runtime-call correlation id -> (thread, start)
        corr = []
        window = None
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if name.startswith(SPAN):
                    s = e.start_ns()
                    rec = (s, s + e.duration_ns(), name[len(SPAN):])
                    if name == WINDOW:
                        window = rec
                    else:
                        self.spans[e.start_thread_id()].append(rec)
                elif name.startswith("cu"):  # CUDA runtime and driver calls
                    launch[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            elif not e.is_user_annotation():  # a span's device-side copy is no work
                s = e.start_ns()
                self.device.append((s, s + e.duration_ns(), name))
                corr.append(e.correlation_id())
        if window is None:
            raise RuntimeError("the traced run recorded no window span")
        self.t0, self.t1 = window[0], window[1]
        inside = [i for i, d in enumerate(self.device) if d[1] > self.t0 and d[0] < self.t1]
        self.device = [self.device[i] for i in inside]
        self._launch = [launch.get(corr[i]) for i in inside]
        self._seg = {t: _segments(v) for t, v in self.spans.items()}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """Union of the device intervals, clipped to the window."""
        out = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            elif e > s:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def _innermost(self, thread, t):
        """Name of the innermost span on `thread` open at time t, or None."""
        times, names = self._seg.get(thread, ((), ()))
        i = bisect.bisect_right(times, t) - 1
        return names[i] if i >= 0 else None

    def device_seconds_in(self, name: str) -> float:
        """Device time of the operations launched inside spans `name`."""
        total = 0
        for (s, e, _), src in zip(self.device, self._launch):
            if src is not None and self._innermost(*src) == name:
                total += e - s
        return total / 1e9

    def span_seconds(self, name: str, parent: str) -> float:
        """Seconds in the spans `name` opened directly inside a span
        `parent` (None: inside no span but the window), each extended to
        the end of the last device operation launched inside it (its nested
        spans included); where the extended spans overlap, the overlap
        counts once."""
        spans = {}  # thread -> [[start, end, extended end]], by start
        for thread, recs in self.spans.items():
            stack, mine = [], []
            for s, e, n in sorted(recs, key=lambda x: (x[0], -x[1])):
                while stack and stack[-1][1] <= s:
                    stack.pop()
                if n == name and (stack[-1][2] if stack else None) == parent:
                    mine.append([s, e, e])
                stack.append((s, e, n))
            if mine:
                spans[thread] = mine
        starts = {t: [m[0] for m in v] for t, v in spans.items()}
        for (_, end, _), src in zip(self.device, self._launch):
            if src is None or src[0] not in spans:
                continue
            mine = spans[src[0]]
            i = bisect.bisect_right(starts[src[0]], src[1]) - 1
            if i >= 0 and src[1] <= mine[i][1]:
                mine[i][2] = max(mine[i][2], end)
        total = 0
        for mine in spans.values():
            reached = None
            for s, _, x in mine:
                lo = s if reached is None else max(s, reached)
                total += max(0, x - lo)
                reached = x if reached is None else max(reached, x)
        return total / 1e9

    def device_ops(self, top: int = 10):
        by = defaultdict(int)
        for s, e, name in self.device:
            by[name] += e - s
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_host_span(self, thread, top: int = 10):
        """Device idle time inside the window, split by the innermost
        benchmark span open on the host thread over each part of each gap."""
        times, names = self._seg.get(thread, ([], []))
        by = defaultdict(int)
        prev = self.t0
        for s, e in self.busy_intervals() + [[self.t1, self.t1]]:
            t = prev
            i = bisect.bisect_right(times, t) - 1
            while t < s:  # the gap [prev, s), cut where the innermost span changes
                nxt = times[i + 1] if i + 1 < len(times) else s
                end = min(s, nxt)
                by[(names[i] if i >= 0 else None) or "outside spans"] += end - t
                t, i = end, i + 1
            prev = max(prev, e)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def main_thread(self):
        """The host thread that holds the most benchmark spans."""
        return max(self.spans, key=lambda t: len(self.spans[t])) if self.spans else None
