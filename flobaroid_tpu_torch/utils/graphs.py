"""CUDA graphs of a device function of fixed shapes: its launches captured
once and replayed, so the host makes a handful of calls per run instead of
dispatching every kernel.

`GraphCache` keeps one graph per key, least recently used evicted first. A
key's first `capture_at - 1` calls run eager; they double as the warm-up
that capture needs (lazy constants, library handles), and a key seen that
few times never pays for a capture. The next call captures, later calls
replay. The caller builds the key from everything the function reads as a
constant (shapes, dtype, options), keeps one cache per device, and calls
it only with CUDA tensors.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable

import torch


class Captured:
    """fn(*args) captured in one CUDA graph on static copies of args
    (None stays None), with its own memory pool and capture stream on the
    device of args[0]. A call copies its args into the static inputs,
    replays the graph and returns a fresh copy of the static output, with
    the output's strides, so that no caller sees its result overwritten
    by the next replay. Dropping the object frees the graph's pool.

    The capture is `torch.cuda.graph` without its synchronize, garbage
    collection and `empty_cache`: the capture stream waits on the current
    one instead, and the allocator keeps its cached blocks, which the
    work after the capture would otherwise have to allocate anew."""

    def __init__(self, fn: Callable, args: tuple):
        self.device = args[0].device
        self.inputs = [None if a is None else a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                self.output = fn(*self.inputs)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)

    def __call__(self, args: tuple) -> torch.Tensor:
        with torch.cuda.device(self.device):
            for s, a in zip(self.inputs, args):
                if s is not None:
                    s.copy_(a)
            self.graph.replay()
            out = self.output
            return torch.empty_strided(out.size(), out.stride(), dtype=out.dtype,
                                       device=out.device).copy_(out)


class GraphCache:
    """At most `bound` keys, each holding the count of its eager calls so
    far or, from its `capture_at`-th call on, its captured graph; the least
    recently used key goes first, and its graph with it."""

    def __init__(self, bound: int, capture_at: int):
        self.bound, self.capture_at = bound, capture_at
        self.entries: OrderedDict[Any, int | Captured] = OrderedDict()

    def __call__(self, key, fn: Callable, args: tuple) -> tuple[Any, str]:
        """fn(*args), and how it ran: "eager", "capture" or "replay"."""
        entries = self.entries
        held = entries[key] = entries.pop(key, 0)  # now the most recently used
        if len(entries) > self.bound:
            entries.popitem(last=False)
        if not isinstance(held, int):
            return held(args), "replay"
        if held + 1 < self.capture_at:
            entries[key] = held + 1
            return fn(*args), "eager"
        graph = entries[key] = Captured(fn, args)
        return graph(args), "capture"
