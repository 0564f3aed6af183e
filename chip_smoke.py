"""Chip smoke test of the PyTorch/CUDA port (flobaroid_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script
exits non-zero, printing no result):
  0. device: torch/CUDA versions and the card's name and power limit;
  1. build: compiles the Gram kernel (csrc/gram.cu) from the checkout;
  2. kernel vs plain: the Gram kernel against the plain PyTorch version
     (computed in f64 on the same inputs) at the main path's shapes and
     the widest Gram the repository uses; tolerance 1e-5 of max|G|;
     CUDA-event times of the kernel and of the plain f32 version;
  3. main path, bench-equivalent (bench.py's headline): the 7-DOF arm,
     2000 random states, simulate -> streamed per-channel Grams -> OLS ->
     physically consistent SDP -> reporting, one cold and 5 warm passes,
     held to the bench's gates; the kernel's launch count must rise in
     both Gram sites (structural and per-channel);
  4. the same at 60 000 states (a 5-minute log at 200 Hz);
  5. the port on the card against the port on the CPU (plain versions)
     on the checked-in structural cache, so both use one projection.
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
GRAM_TOL = 1e-5  # max|G_kernel - G_f64| / max|G_f64| (plain f32 FMA, split sum chains)
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


def phase_kernels(gram) -> dict:
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = [  # (name, N, B, C)
        ("structural_B1_M14000_C80", 14000, 1, 80),
        ("per_channel_B7_N2000_C82", 2000, 7, 82),
        ("per_channel_B7_N60000_C82", 60000, 7, 82),
        ("humanoid30_B30_N13770_C342", 13770, 30, 342),
        ("ragged_M1037_C37", 1037, 1, 37),
    ]
    out = {}
    for name, N, B, C in shapes:
        Y = torch.randn((N, B, C), generator=gen, device="cuda", dtype=torch.float32)
        Gk = gram.gram_batched(Y)
        G64 = gram.gram_plain(Y.double())
        torch.cuda.synchronize()
        rel = float((Gk.double() - G64).abs().max() / G64.abs().max())
        abs_err = float((Gk.double() - G64).abs().max())
        check(np.isfinite(rel) and rel <= GRAM_TOL,
              f"Gram kernel {name}: rel err {rel:.3g} > {GRAM_TOL}")
        check(torch.equal(Gk, gram.gram_batched(Y)), f"Gram kernel {name}: not reproducible")
        ms = event_times_ms(lambda: gram.gram_batched(Y))
        plain_ms = event_times_ms(lambda: gram.gram_plain(Y))
        out[name] = dict(N=N, B=B, C=C, rel_err=rel, max_abs_err=abs_err,
                         ms=ms, plain_ms=plain_ms)
        emit("kernel_vs_plain", shape=name, **out[name])
    return out


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
        check(min(launches_per_pass) > 0, f"{label}: no Gram launch in the streamed pass")
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
        for label, n, warm in (("main_path_N2000", 2000, 5), ("main_path_N60000", 60000, 2)):
            urdf = os.path.join(tmp, f"{label}.urdf")
            shutil.copy(ARM_URDF, urdf)  # structural cache miss: _random_gram runs
            run_main_path(gram, urdf, n, warm, "cuda", label)
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
    check("jax" not in sys.modules, "jax was imported")

    main_shape = kern["per_channel_B7_N2000_C82"]
    print(json.dumps({"kernels": [{
        "name": "gram_batched",
        "route": "cuda",
        "source": "flobaroid_tpu_torch/csrc/gram.cu",
        "replaces": "flobaroid_tpu/ops/gram.py:48",
        "launches": total_launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
