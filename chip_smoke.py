"""Chip smoke test of the PyTorch/CUDA port (flobaroid_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script
exits non-zero, printing no result):
  0. device: torch/CUDA versions and the card's name and power limit;
  1. build: compiles the Gram kernel (csrc/gram.cu) from the checkout;
  2. kernel vs plain: the Gram kernel against the plain PyTorch version
     (computed in f64 on the same inputs) at every shape the main path
     sends it (the structural Gram, and the per-channel chunks of 2000,
     4096 and the 2656-sample tail of 60 000) and at three extra shapes
     no path of this slice runs (60 000 rows in one call, the widest
     Gram the repository uses, a ragged C), each Y laid out as the Gram
     sites build it (rows padded to 16 bytes; the ragged shape is
     contiguous and goes through the wrapper's copy); tolerance 1e-5 of
     max|G|, bitwise reproducible, one launch per call; CUDA-event times
     of one call of the kernel and of the plain f32 version, and the
     least time the card could take (bytes or operations);
  3. main path, bench-equivalent (bench.py's headline): the 7-DOF arm,
     2000 random states, simulate -> streamed per-channel Grams -> OLS ->
     physically consistent SDP -> reporting, one cold and 5 warm passes,
     held to the bench's gates; the kernel's launch count must rise in
     both Gram sites (structural and per-channel), once per chunk of
     samples, and every chunk must be a shape phase 2 checked;
  4. the same at 60 000 states (a 5-minute log at 200 Hz);
  5. the port on the card against the port on the CPU (plain versions)
     on the checked-in structural cache, so both use one projection; the
     structural rank found on the card (phases 3-4, cache misses) must
     equal the CPU run's;
  6. device times from torch.profiler of the kernel and of the library
     call (the einsum) in turns at phase 2's shapes, and the kernel's
     share of its bound; last, so no profiler session runs before the
     main path's walls are read.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
GRAM_TOL = 1e-5  # max|G_kernel - G_f64| / max|G_f64| (split-TF32 tensor cores, f64 split sums)
# published peaks of the NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s,
# dense TF32 tensor-core FLOP/s (the fastest unit an f32-accurate Gram can use)
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 495e12
BENCH_OPTIONS = dict(
    floatingBase=0, simulateTorques=1, useStructuralRegressor=1,
    randomSamples=2000, estimateWith="std", materializeRegressor=0,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=1.0,
    limitMassToApriori=1, limitMassAprioriBoundary=0.3, verbose=0,
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_samples(model, n: int, freq: float = 200.0) -> dict:
    """bench.py's samples: random in-limit states, numpy seed 42."""
    lims = model.limits
    names = model.jointNames
    lo = np.array([lims[j]["lower"] for j in names])
    hi = np.array([lims[j]["upper"] for j in names])
    vl = np.array([min(lims[j]["velocity"], 10.0) for j in names])
    rng = np.random.default_rng(42)
    nd = len(names)
    return {
        "positions": lo + (hi - lo) * rng.random((n, nd)),
        "velocities": (rng.random((n, nd)) - 0.5) * 2 * vl,
        "accelerations": (rng.random((n, nd)) - 0.5) * 2 * np.pi,
        "torques": np.zeros((n, nd)),
        "times": np.arange(n) / freq,
        "frequency": np.array(freq),
    }


def event_times_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, sessions: int = 3) -> tuple[float, list[str]]:
    """Device time of one call: the CUDA kernels' time in a torch.profiler
    window of `reps` calls, over `reps`, and the kernels' names. A session
    now and then records no kernel at all (seen once in ~30 sessions of
    one process on an H100); such a session is reported and run again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            return (sum(e.device_time_total for e in kernels) / 1e3 / reps,
                    sorted({e.name for e in kernels}))
        print("torch.profiler recorded no CUDA kernel; profiling again", file=sys.stderr)
    raise RuntimeError(f"chip smoke check failed: torch.profiler recorded no CUDA kernel "
                       f"in {sessions} sessions")


def gram_bound_ms(N: int, B: int, C: int) -> tuple[float, str]:
    """The least time the card could take for the Gram: Y read once and G
    written once at the memory rate, or the symmetric product's
    N*B*C*(C+1) FLOP at the TF32 peak, whichever is larger."""
    t_bytes = 4 * (N * B * C + B * C * C) / PEAK_BYTES_PER_S * 1e3
    t_ops = N * B * C * (C + 1) / PEAK_TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def physically_consistent(idf) -> bool:
    """PSD spatial inertia of every non-empty link of the identified
    standard parameters (the constraint the SDP enforces)."""
    import torch

    from flobaroid_tpu_torch.dynamics.spatial import inertia_matrix_from_params

    m = idf.model
    x = idf._full_xstd()[: m.num_model_params].reshape(m.num_links, 10)
    for p in x:
        if np.all(np.abs(p) < 1e-12):
            continue
        ev = np.linalg.eigvalsh(inertia_matrix_from_params(torch.tensor(p)).numpy())
        if ev[0] < -1e-10 * max(1.0, abs(ev[-1])):
            return False
    return True


# (name, N, B, C, on the main path). The per-channel site runs in chunks
# of gramChunk = 4096 samples: N=2000 is one chunk, N=60 000 is 14 chunks
# of 4096 and a tail of 2656. The extra shapes are run by no path here.
KERNEL_SHAPES = [
    ("structural_B1_M14000_C80", 14000, 1, 80, True),
    ("per_channel_B7_N2000_C82", 2000, 7, 82, True),
    ("per_channel_chunk_B7_N4096_C82", 4096, 7, 82, True),
    ("per_channel_tail_B7_N2656_C82", 2656, 7, 82, True),
    ("extra_one_call_B7_N60000_C82", 60000, 7, 82, False),
    ("extra_humanoid30_B30_N13770_C342", 13770, 30, 342, False),
    ("extra_ragged_M1037_C37", 1037, 1, 37, False),
]
PER_CHANNEL_ROWS = {N for _, N, B, C, on_path in KERNEL_SHAPES if on_path and (B, C) == (7, 82)}


def kernel_input(gen, name: str, N: int, B: int, C: int):
    """Y as the Gram sites build it (ops.gram.cat_padded: rows padded to
    16 bytes); the ragged shape is contiguous and goes through the
    wrapper's copy."""
    import torch

    width = C if "ragged" in name else C + (-C % 4)
    return torch.randn((N, B, width), generator=gen, device="cuda", dtype=torch.float32)[..., :C]


def phase_kernels(gram) -> dict:
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for name, N, B, C, on_path in KERNEL_SHAPES:
        Y = kernel_input(gen, name, N, B, C)
        before = gram.launches
        Gk = gram.gram_batched(Y)
        check(gram.launches == before + 1, f"Gram kernel {name}: {gram.launches - before} launches")
        G64 = gram.gram_plain(Y.double())
        torch.cuda.synchronize()
        rel = float((Gk.double() - G64).abs().max() / G64.abs().max())
        abs_err = float((Gk.double() - G64).abs().max())
        check(np.isfinite(rel) and rel <= GRAM_TOL,
              f"Gram kernel {name}: rel err {rel:.3g} > {GRAM_TOL}")
        check(torch.equal(Gk, gram.gram_batched(Y)), f"Gram kernel {name}: not reproducible")
        ms = event_times_ms(lambda: gram.gram_batched(Y))
        plain_ms = event_times_ms(lambda: gram.gram_plain(Y))
        bound, bound_by = gram_bound_ms(N, B, C)
        out[name] = dict(N=N, B=B, C=C, on_main_path=on_path, row_stride=Y.stride(0),
                         rel_err=rel, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_us=bound * 1e3, bound_by=bound_by)
        emit("kernel_vs_plain", shape=name, **out[name])
    return out


def phase_device_times(gram, kern: dict) -> None:
    """torch.profiler device times of the kernel and of the library call
    (the plain version's einsum, the yardstick) in turns: kernel,
    library, library, kernel. Run after the main path: the main path's
    walls are read with no profiler session before them in the process."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name, N, B, C, _ in KERNEL_SHAPES:
        Y = kernel_input(gen, name, N, B, C)
        k1, k_names = device_ms(lambda: gram.gram_batched(Y))
        l1, l_names = device_ms(lambda: gram.gram_plain(Y))
        l2, _ = device_ms(lambda: gram.gram_plain(Y))
        k2, _ = device_ms(lambda: gram.gram_batched(Y))
        check(any("gram_tf32_kernel" in n for n in k_names), f"Gram kernel {name}: not in {k_names}")
        dev, lib = (k1 + k2) / 2, (l1 + l2) / 2
        times = dict(device_ms=dev, device_ms_turns=[k1, k2], library_ms=lib,
                     library_ms_turns=[l1, l2], bound_share=kern[name]["bound_ms"] / dev,
                     kernels=k_names, library_kernels=l_names)
        kern[name].update(times)
        emit("kernel_device_time", shape=name, **times)


def run_main_path(gram, urdf: str, n: int, warm: int, device: str, label: str,
                  opt_overrides: dict | None = None, cache_miss: bool = True) -> dict:
    """Identification(opt, urdf, device).estimateParameters(): one cold
    pass, then `warm` passes on the same object, held to bench.py's gates.
    Launch counts are the kernel launches made within this call."""
    import torch

    from flobaroid_tpu_torch.identification.identifier import Identification
    from flobaroid_tpu_torch.utils.config import load_config

    opt = load_config(None, overrides={**BENCH_OPTIONS, **(opt_overrides or {})})
    start = gram.launches
    t0 = time.perf_counter()
    idf = Identification(dict(opt), urdf, device=device)
    t_init = time.perf_counter() - t0
    structural_launches = gram.launches - start
    samples = build_samples(idf.model, n)
    chunk = int(opt["gramChunk"])
    chunk_rows = sorted({min(chunk, n - s0) for s0 in range(0, n, chunk)})
    walls, launches_per_pass = [], []
    for _ in range(1 + warm):
        before = gram.launches
        t0 = time.perf_counter()
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        if device == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches_per_pass.append(gram.launches - before)
    m = idf.model
    xb_err = float(np.linalg.norm(m.xBase - m.xBaseModel) / np.linalg.norm(m.xBaseModel))
    w = walls[1:]
    res = dict(
        n_samples=n, device=device,
        init_s=t_init, cold_s=walls[0], warm_s=w,
        warm_min_s=min(w) if w else None, warm_mean_s=float(np.mean(w)) if w else None,
        warm_max_s=max(w) if w else None,
        stage_times_s=idf.stage_times, num_base_params=m.num_base_params,
        res_error_pct=float(idf.res_error), base_param_rel_err=xb_err,
        physically_consistent=physically_consistent(idf),
        sdp_status=idf.sdp.last_status, sdp_info=idf.sdp.last_info,
        G_rows_device=str(m.G_rows.device),
        structural_launches=structural_launches, launches_per_pass=launches_per_pass,
        chunk_rows=chunk_rows,
        xBase=m.xBase.tolist(),
    )
    emit(label, **{k: v for k, v in res.items() if k != "xBase"})
    check(res["res_error_pct"] < 1.0, f"{label}: res_error {res['res_error_pct']}")
    check(xb_err < 0.05, f"{label}: base-parameter error {xb_err}")
    check(res["physically_consistent"], f"{label}: not physically consistent")
    check(res["sdp_status"] == "optimal", f"{label}: sdp status {res['sdp_status']}")
    check(m.G_rows.device.type == device, f"{label}: G_rows on {m.G_rows.device}")
    if device == "cuda":
        if cache_miss:
            check(structural_launches > 0, f"{label}: no Gram launch in _random_gram")
        check(all(k == -(-n // chunk) for k in launches_per_pass),
              f"{label}: {launches_per_pass} Gram launches per pass, not one per chunk")
        check(set(chunk_rows) <= PER_CHANNEL_ROWS,
              f"{label}: chunks of {chunk_rows} rows, not all checked in phase 2")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    from flobaroid_tpu_torch.ops import _build, gram

    smi = gpu_name_power()
    name = torch.cuda.get_device_name(0)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, name=name,
         nvidia_smi=smi, python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build_library("gram")
    gram._lib()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in _build.build_logs.get("gram", "").splitlines()
                if "registers" in ln or "spill" in ln])

    kern = phase_kernels(gram)

    tmp = tempfile.mkdtemp(prefix="flobaroid_chip_smoke_")
    try:
        gram.launches = 0
        card_ranks = {}
        for label, n, warm in (("main_path_N2000", 2000, 5), ("main_path_N60000", 60000, 2)):
            urdf = os.path.join(tmp, f"{label}.urdf")
            shutil.copy(ARM_URDF, urdf)  # structural cache miss: _random_gram runs
            card_ranks[label] = run_main_path(gram, urdf, n, warm, "cuda", label)["num_base_params"]
        total_launches = gram.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the port on the card vs on the CPU, both on the checked-in cache
    # (randomSamples=600 hits it, so both use one structural projection)
    same = dict(opt_overrides=dict(randomSamples=600), cache_miss=False)
    rg = run_main_path(gram, ARM_URDF, 2000, 0, "cuda", "cuda_vs_cpu_cuda", **same)
    rc = run_main_path(gram, ARM_URDF, 2000, 0, "cpu", "cuda_vs_cpu_cpu", **same)
    xg, xc = np.asarray(rg["xBase"]), np.asarray(rc["xBase"])
    dx = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
    dres = abs(rg["res_error_pct"] - rc["res_error_pct"])
    emit("cuda_vs_cpu", xBase_rel_diff=dx, res_error_diff_pct_points=dres,
         sdp_status=[rg["sdp_status"], rc["sdp_status"]])
    check(dx <= 1e-4, f"cuda vs cpu xBase rel diff {dx}")
    check(rg["sdp_status"] == rc["sdp_status"], "cuda vs cpu sdp status")
    check(dres <= 1e-3, f"cuda vs cpu res_error diff {dres}")
    for label, rank in card_ranks.items():
        check(rank == rc["num_base_params"],
              f"{label}: structural rank {rank} on the card, {rc['num_base_params']} on the CPU")
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "flobaroid_tpu" or m.startswith("flobaroid_tpu.") for m in sys.modules),
          "the JAX package flobaroid_tpu was imported")

    phase_device_times(gram, kern)
    # the shape the main path launches most: N=60 000's 4096-sample chunk.
    # ms / plain_ms: CUDA-event time of one call (host included) of the
    # kernel / of the plain version; device_ms / library_ms: torch.profiler
    # device time of the kernel / of the library call. gram_plain is the
    # einsum, so the plain version and the library call are one call.
    main_shape = kern["per_channel_chunk_B7_N4096_C82"]
    print(json.dumps({"kernels": [{
        "name": "gram_batched",
        "route": "cuda",
        "source": "flobaroid_tpu_torch/csrc/gram.cu",
        "replaces": "flobaroid_tpu/ops/gram.py:48",
        "launches": total_launches,
        "shape": "4096x7x82",
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "device_ms": main_shape["device_ms"],
        "library_ms": main_shape["library_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
