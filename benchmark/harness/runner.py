"""One run of one cell: set-up, the measured window (traced or not), the
check of the outputs against the plain reference, the result line."""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from . import device as card, manifest, modules, trace, window

STARTED = time.perf_counter()
TRACED_S = 15.0


def _seconds_since_process_start() -> float:
    """Seconds from this process's start to now (Linux /proc; else from the
    import of this module)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - STARTED


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _wrap(owner, attr, name):
    fn = getattr(owner, attr)

    def wrapped(*a, **k):
        with trace.span(name):
            return fn(*a, **k)

    setattr(owner, attr, wrapped)
    return lambda: setattr(owner, attr, fn)


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda") -> tuple[int, dict | None]:
    """Returns (exit code, result). A result is None when the run may not
    report: no card or too few, or a forbidden module loaded."""
    man = manifest.load(root)
    cell = manifest.workload(man, workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"needs {cell['chips']} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2, None
    # the reference's float32 products are float32, not TF32; the program's
    # own kernels do not read these flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = manifest.config(root, man, cell["config"])
    spec = manifest.traffic(root, cell["traffic"])
    kind = manifest.kind(root, spec)
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        return _run(root, man, cell, config, spec, kind, seed, seconds, traced, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(root, man, cell, config, spec, kind, seed, seconds, traced, device, workdir):
    name = cell["name"]
    c = kind.Cell(root, config, spec, seed, device, workdir)
    log(f"setup start {_seconds_since_process_start():.3f} s after the process started")
    for part, secs in c.setup():
        log(f"setup {part} {secs:.3f} s")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = _seconds_since_process_start()
    log(f"setup_s {setup_s:.3f}")

    # a traced run traces the units of its first TRACED_S seconds and runs
    # the rest of the window untraced: reading a trace costs about three
    # times its length
    undo = [_wrap(*s) for s in c.spans()] if traced else []
    try:
        with trace.profiled(traced) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                part = window.run(c.unit, min(seconds, TRACED_S) if traced else seconds)
    finally:
        for u in undo:
            u()
    win = part
    if traced and part.seconds < seconds:
        win = window.joined(part, window.run(c.unit, seconds - part.seconds, first=len(part.walls)))
    log(f"window {win.seconds:.3f} s, {len(win.walls)} units, {win.failed} failed")
    q = statistics.quantiles(win.walls, n=4) if len(win.walls) > 1 else win.walls * 3
    log(f"unit walls min {min(win.walls):.4f} quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f} "
        f"max {max(win.walls):.4f} s")

    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": int(cell["chips"]) if cuda else 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if cuda:
        log(f"card {card.name_and_power_limit()}")
    result = {"correct": False, "attempted": len(win.walls), "failed": win.failed,
              "metrics": {}, "device": info}
    if traced:
        tr = prof.trace
        t_read = time.perf_counter()
        info["busy_s"], info["window_s"] = tr.busy_s, tr.window_s
        rec = dict(c.layer_record(part), trace=tr)
        for m in manifest.per_layer(man, name, kind):
            value = manifest.reader(root, m["name"]).read(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_by_host_span(tr.main_thread())}
        log(f"per-layer metrics read in {time.perf_counter() - t_read:.3f} s")
    else:
        for m in manifest.end_to_end(man, name, kind):
            value = setup_s if m["name"] == "setup_s" else getattr(win, kind.E2E[m["name"]])
            result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}

    c.release(win)
    t = time.perf_counter()
    numbers = c.judge(win)
    log(f"reference check {time.perf_counter() - t:.3f} s")
    limits = spec["limits"]
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    result["correct"] = bool(win.failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()))

    bad = modules.forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3, None
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    result["checks"] = checks
    return 0, result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code, result = run(root, a.workload, a.seed, a.seconds, bool(a.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
