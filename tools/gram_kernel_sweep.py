"""Sweep the row-split count of the port's Gram kernel
(flobaroid_tpu_torch/csrc/gram.cu) on one NVIDIA card, to calibrate the
planner constants in flobaroid_tpu_torch/ops/gram.py (_BLOCK_COST,
_SPLIT_COST). chip_smoke.py checks and times the kernel as the wrapper
launches it; this tool calls the kernel directly with each split count.

Run from the repository root on a machine with a Hopper card:

    python3 tools/gram_kernel_sweep.py

It builds the kernel, prints ptxas's register and serialization notes,
then for each shape one JSON line: the planner's split count and, for
each split count tried, CUDA-event µs per call over 50 calls and the
error against the plain version in f64.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flobaroid_tpu_torch.ops import _build, gram  # noqa: E402


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def sweep_splits(gen) -> None:
    fn = gram._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for N, B, C in [(14000, 1, 80), (2000, 7, 82), (4096, 7, 82), (60000, 7, 82),
                    (13770, 30, 342)]:
        Y = torch.randn((N, B, C + (-C % 4)), generator=gen, device="cuda")[..., :C]
        sN, sB = gram._tma_strides(Y)
        plan = gram._plan(N, B, C, gram._sm_count(0))
        G64 = gram.gram_plain(Y.double())
        lo = max(1, -(-N // gram._MAX_ROWS))
        hi = max(lo, -(-N // gram._MIN_ROWS))
        res = {}
        for S in sorted({lo, hi, plan.splits, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 18, 20, 24, 32, 40, 55}):
            if not lo <= S <= hi:
                continue
            rows = gram._rows_per_split(N, S)
            S = -(-N // rows)
            ws = torch.empty(S * B * plan.tiles * plan.tile_elems, device="cuda")
            counters = torch.zeros(B * plan.tiles, dtype=torch.int32, device="cuda")
            out = torch.empty((B, C, C), device="cuda")

            def call():
                err = fn(Y.data_ptr(), N, B, C, sN, sB, plan.panel, int(plan.pairs), rows, S,
                         ws.data_ptr(), counters.data_ptr(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"gram kernel launch failed: error {err}")

            call()
            rel = float((out.double() - G64).abs().max() / G64.abs().max())
            res[S] = (round(event_ms(call, 50) * 1e3, 2), f"{rel:.1e}")
        print(json.dumps(dict(shape=[N, B, C], planned=plan.splits, us_by_splits=res)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)
    _build.build_library("gram")
    for line in _build.build_logs.get("gram", "").splitlines():
        if "registers" in line or "serialized" in line or "spill" in line:
            print(line.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sweep_splits(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
