"""The measured window of a closed loop with one client, and the statistic
the end-to-end metrics take from it."""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    seconds: float  # from the first unit's start to the last unit's end
    walls: list = field(default_factory=list)  # seconds of each unit
    outputs: list = field(default_factory=list)
    failed: int = 0

    @property
    def per_unit_s(self) -> float:
        """Window seconds over the units completed in it."""
        return self.seconds / len(self.walls)

    @property
    def p90_s(self) -> float:
        """The 90th percentile of the units' walls (statistics.quantiles)."""
        if len(self.walls) < 2:
            return self.walls[0]
        return statistics.quantiles(self.walls, n=10)[8]


def run(unit, seconds: float, clock=time.perf_counter, first: int = 0) -> Window:
    """Call unit(first), unit(first + 1), ... back to back until `seconds`
    have passed; the unit in flight at that time runs to its end and counts.
    A unit that raises counts as failed and as attempted."""
    w = Window(0.0)
    t0 = clock()
    u = first
    while True:
        s = clock()
        try:
            out = unit(u)
        except Exception as exc:  # noqa: BLE001 - a failed unit is counted, not fatal
            out = None
            w.failed += 1
            print(f"unit {u} failed: {exc!r}", flush=True, file=sys.stderr)
        e = clock()
        w.walls.append(e - s)
        w.outputs.append(out)
        u += 1
        if e - t0 >= seconds:
            w.seconds = e - t0
            return w


def joined(a: Window, b: Window) -> Window:
    """Two windows run back to back as one."""
    return Window(a.seconds + b.seconds, a.walls + b.walls, a.outputs + b.outputs,
                  a.failed + b.failed)
