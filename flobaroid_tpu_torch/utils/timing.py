"""Tracing, timing and profiling utilities.

The port's own spans and counters (`span`, `traced`, `count`,
`host_read`, `Stages`), recorded only while torch.profiler
records (`torch.autograd._profiler_enabled()`): the benchmark's traced
run and the identify CLI's `jaxProfileDir` capture. With no profiler
recording, `span` returns one shared no-op context and `count` returns at
once: one check, no clock read. While one records, a span opens a
profiler range named `flobaroid/<name>`, so exported traces show it beside
the kernels it launched, and appends a `Record` to a bounded in-memory
buffer (`records()`, `counters()`, `reset()`) on the profiler's clock
(`time.time_ns()`, the Unix time kineto reports), read just outside the
range so that the record encloses it.

Also `stage_timer` (the reference's helpers.Timer gated by showTiming,
identification/helpers.py:212-219), the torch.profiler capture in place
of the JAX device profile, and printMemUsage (reference
identifier.py:1424-1438).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import torch

PREFIX = "flobaroid/"
BOUND = 1 << 20  # records kept; later ones are counted in counters()["dropped"]

_enabled = torch.autograd._profiler_enabled
# the profiler's range op without record_function's Python-level dispatch
# (about 2 us a span against 17 us on a CPU build); a function-scope range,
# so it adds no device-side annotation to the trace
_RecordFunction = torch._C._profiler._RecordFunctionFast


@dataclass(slots=True)
class Record:
    """One span: its id, its parent's (None for a root), its root's (its
    own for a root), name, host thread (`threading.get_ident()`), start and
    end in Unix ns (end None while open), and attrs: the span's own
    attributes plus the counters incremented while it was the innermost
    open span."""

    id: int
    parent: int | None
    root: int
    name: str
    thread: int
    start_ns: int
    end_ns: int | None
    attrs: dict


class _Buffer:
    """The records and counter totals of this process, bounded at BOUND
    records."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[Record] = []
        self.counters: dict[str, int] = {}
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list[Record]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: Record) -> None:
        with self.lock:
            if len(self.records) < BOUND:
                self.records.append(rec)
            else:
                self.counters["dropped"] = self.counters.get("dropped", 0) + 1

    def count(self, name: str, n: int) -> None:
        st = self.stack()
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if st:
                a = st[-1].attrs
                a[name] = a.get(name, 0) + n


_buffer = _Buffer()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _buffer.stack()
        parent = st[-1] if st else None
        self.rf = _RecordFunction(PREFIX + self.name)
        start = time.time_ns()
        self.rf.__enter__()
        rid = next(_buffer.ids)
        rec = Record(rid, parent.id if parent else None, parent.root if parent else rid,
                     self.name, threading.get_ident(), start, None, self.attrs)
        _buffer.add(rec)
        st.append(rec)
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _buffer.stack().pop().end_ns = time.time_ns()
        return False


def span(name: str, **attrs):
    """A context manager: the span `name` while a profiler records, else
    the shared no-op."""
    if not _enabled():
        return _OFF
    return _Span(name, attrs)


def traced(name: str):
    """Decorator: each call of the function runs in span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            if not _enabled():
                return fn(*a, **k)
            with _Span(name, {}):
                return fn(*a, **k)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` and to the innermost open span's
    record, while a profiler records."""
    if _enabled():
        _buffer.count(name, n)


def host_read(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(), the host waiting on the device: the span `host_read`,
    counted in `host_reads`, while a profiler records."""
    if not _enabled():
        return t.cpu()
    with _Span("host_read", {}):
        _buffer.count("host_reads", 1)
        return t.cpu()


def records() -> list[Record]:
    """The spans recorded since the last reset, in the order they opened."""
    with _buffer.lock:
        return list(_buffer.records)


def counters() -> dict[str, int]:
    """Counter totals since the last reset (`dropped`: records past BOUND)."""
    with _buffer.lock:
        return dict(_buffer.counters)


def reset() -> None:
    with _buffer.lock:
        _buffer.records.clear()
        _buffer.counters.clear()


class Stages:
    """Host seconds of one call's consecutive stages: `with stage(name):`
    adds to times[name] the seconds from the end of the previous stage (or
    this object's creation) to its own end: one `perf_counter` read per
    boundary, traced or not. While a profiler records, each stage is also
    the span `<prefix>/<name>`."""

    def __init__(self, times: dict, prefix: str):
        self.times, self.prefix = times, prefix
        self._t = time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        try:
            with span(self.prefix + "/" + name):
                yield
        finally:
            now = time.perf_counter()
            self.times[name] = self.times.get(name, 0.0) + now - self._t
            self._t = now


@contextlib.contextmanager
def stage_timer(name: str, opt: dict | None = None):
    """Print '<name> took X s' when showTiming is enabled."""
    t0 = time.perf_counter()
    yield
    if opt is None or opt.get("showTiming"):
        print(f"({name} took {time.perf_counter() - t0:.3f} sec.)")


@contextlib.contextmanager
def torch_profile(logdir: str | None):
    """Capture a torch.profiler trace of the block (host ops, and the
    CUDA kernels when a card is present) into `logdir`/trace.json, a
    Chrome trace (chrome://tracing, Perfetto). No-op when logdir is
    falsy. The config key is the JAX package's `jaxProfileDir`."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profile written to {path}")


def _nbytes(v) -> int | None:
    """Bytes held by a tensor (element_size * nelement) or an array."""
    if hasattr(v, "element_size") and hasattr(v, "nelement"):
        return int(v.element_size() * v.nelement())
    if hasattr(v, "nbytes"):
        return int(v.nbytes)
    return None


def print_mem_usage(variables: dict[str, Any]) -> None:
    """Rough per-array memory report (reference identifier.py:1424-1438):
    tensors (any device) and numpy arrays, the 20 largest."""
    rows = []
    for name, v in variables.items():
        nb = _nbytes(v)
        if nb is not None:
            rows.append((name, nb))
    rows.sort(key=lambda r: -r[1])
    total = 0
    for name, nb in rows[:20]:
        print(f"  {name:<30} {nb / 1e6:10.2f} MB")
        total += nb
    print(f"  {'total (top 20)':<30} {total / 1e6:10.2f} MB")
