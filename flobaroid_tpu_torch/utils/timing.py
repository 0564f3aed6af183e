"""Timing / progress / profiling utilities.

Counterpart of flobaroid_tpu/utils/timing.py (the reference's
helpers.Timer gated by showTiming, helpers.Progress gated on verbose,
printMemUsage; reference identification/helpers.py:201-219,
identifier.py:1424-1438), with a torch.profiler capture in place of the
JAX device profile.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterable


class Timer:
    """`with Timer() as t: ...; t.interval` (reference helpers.py:212-219)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.interval = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def stage_timer(name: str, opt: dict | None = None):
    """Print '<name> took X s' when showTiming is enabled."""
    t0 = time.perf_counter()
    yield
    if opt is None or opt.get("showTiming"):
        print(f"({name} took {time.perf_counter() - t0:.3f} sec.)")


class Progress:
    """tqdm progress bars gated on verbose (reference helpers.py:201-209)."""

    def __init__(self, config: dict):
        self.config = config

    def progress(self, it: Iterable) -> Iterable:
        if self.config.get("verbose"):
            try:
                from tqdm import tqdm

                return tqdm(it)
            except ImportError:
                return it
        return it


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
