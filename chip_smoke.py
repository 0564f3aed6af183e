"""Chip smoke test of the PyTorch/CUDA port (flobaroid_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and the script
exits non-zero, printing no result):
  0. device: torch/CUDA versions and the card's name and power limit;
  1. build: compiles the Gram kernel (csrc/gram.cu) from the checkout;
  2. kernel vs plain: the Gram kernel against the plain PyTorch version
     (computed in f64 on the same inputs) at every shape a path of this
     script sends it (the arm's structural Gram and per-channel chunks
     of 2000, 4096 and the 2656-sample tail of 60 000; humanoid30's
     structural Gram, its 4096-sample walking chunk, the 1482-sample tail
     of 13 770, the 1200-sample card-vs-CPU run and the CAD study's 1000
     samples) and at two extra shapes no path runs (60 000 rows in one
     call, a ragged C), each Y
     laid out as the Gram sites build it (rows padded to 16 bytes; the
     ragged shape is contiguous and goes through the wrapper's copy);
     tolerance 1e-5 of max|G|, bitwise reproducible, one launch per
     call; CUDA-event times of one call of the kernel and of the plain
     f32 version, and the least time the card could take (bytes or
     operations);
  3. main path, bench-equivalent (bench.py's headline): the 7-DOF arm,
     2000 random states, simulate -> streamed per-channel Grams -> OLS ->
     physically consistent SDP -> reporting, one cold and 5 warm passes,
     held to the bench's gates; then the same at 60 000 states (a
     5-minute log at 200 Hz), one cold and 2 warm passes. The kernel's
     launch count must rise in both Gram sites (structural and
     per-channel), once per chunk of samples, and every launch must be
     at a shape phase 2 checked;
  4. walking leg (bench.py's second leg): humanoid30 (30 DOF, floating
     base, two foot contacts, P = 430), first a structural cache miss
     (one launch at 72 000 x 1 x 430, rank 310), then the walking
     scenario of 13 770 samples generated on the card and identified
     with bench.py's options on the checked-in cache, one cold and 3
     warm passes, held to BENCH_r05's accuracy (torque residual, base
     distance, base cond, SDP optimal) and to 4 launches per pass;
  5. CAD-study leg (bench.py's third leg): the checked-in suspended
     recording of humanoid30 (2000 samples, every second one used: N =
     1000, 36 rows, P = 430, rank 310 on the checked-in cache) identified
     against the CAD model with the four CAD-prior modes (uniform,
     observability, geometric log-det, geometric with observability
     weighting) by `run_cad_study`, a cold and a warm study on one
     Identification, held to the JAX package's base distances of record
     (within 3 %), bench.py's ordering, optimal statuses and one kernel
     launch per study (the four modes share one regressor pass); the same
     study on the CPU in f64 beside it;
  6. trajectory leg (bench.py's fourth leg): the D-optimal excitation
     optimizer on the 7-DOF arm with the checked-in example configuration
     and bench.py's budget (64 candidates x 8 CEM generations, 8
     augmented-Lagrangian restarts of 600 Adam steps, 897 samples, capsule
     collision constraints, the result verified against exact convex
     hulls), at optimizer seeds 0-4, held to: feasible (the mesh check
     included), better than its start, the mean within 5 % of the JAX
     package's mean over the same seeds, and the card's first-generation
     evaluation within 1e-3 of the port on the CPU in f64. The structural
     Gram at Model init is the leg's one kernel launch (14 000 x 1 x 101
     with the configuration's friction columns). When no seed needed the
     mesh back-off, it runs on the card with a stand-in geometry (the
     arm, 157 samples): it must end verified, losing at most 5 % of the
     D-optimality;
  7. suspended leg: the objective of the 30-DOF suspended humanoid
     (floating base hanging from `crane_ft`, the ball-joint integrator
     inside the differentiable chain): 12 candidates evaluated and one
     augmented-Lagrangian gradient for 2 restarts, finite, the values
     within 1e-3 of the CPU in f64; then the exact-mesh verifier at
     humanoid30's full width (box geometry, 421 pairs) over those 12
     candidates at every sample in one call on the card, the first two
     again on the CPU (the port in f32): within 1e-4 m, identical
     verdicts; and the plates and U-channel of tests/test_collision_mesh.py
     (convex and full tiers, the native library built with g++);
  8. simulator leg: `generate_suspended_measurements` of the perturbed
     humanoid (40 s at 50 Hz, 2000 samples, seed 0) on the card, held
     against the same call on the CPU in f64, then identified with the
     geometric CAD prior (base distance within 3 % of the JAX package's
     figure on its own recording); then the static-posture optimizer on
     the arm with the defaults (first generation within 1e-3 of the CPU
     in f64, the result no worse than it), the Euler-Lagrange oracle
     against the engine's RNEA in f64 (arm fixed base, humanoid30 floating
     base, 4 states each: 1e-8 / 1e-7), and humanoid30's structural
     identifiability and sensor-placement study equal to the JAX
     package's figures;
  9. the port on the card against the port on the CPU (plain versions)
     on the checked-in structural caches, so both use one projection:
     the arm at 2000 states and humanoid30 walking at 1200; the
     structural rank found on the card (phases 3-4, cache misses) must
     equal the CPU run's; the arm's essential parameters from noisy
     torques (the same essential set from the card's f32 Grams);
 10. device times from torch.profiler of the kernel and of the library
     call (the einsum) in turns at phase 2's shapes, and the kernel's
     share of its bound, and the kernel launches of one full-width mesh
     verification; last, so no profiler session runs before the main
     path's walls are read.
After phase 3 `regressor_rows_per_sec` (bench.py:397-419) is measured:
`regressor_batch` alone on the arm's 2000 states in f32, 20 repetitions
between CUDA events.
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
from collections import Counter
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
H30_REAL_URDF = os.path.join(REPO, "examples", "models", "humanoid30_real.urdf")
H30_CAD_RECORDING = os.path.join(REPO, "examples", "data", "humanoid30_suspended_cad.npz")
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
WALK_OPTIONS = dict(  # bench.py:90-98
    floatingBase=1, identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0,
    limitMassToApriori=1, limitMassAprioriBoundary=0.5,
    cadRegularizationMode="observability", useStructuralRegressor=1, randomSamples=2000,
    materializeRegressor=0, estimateWith="std", verbose=0,
)
WALK_N = 13770
# the JAX package's accuracy on this leg (BENCH_r05, 13 770 samples)
WALK_RES_ERROR_PCT = 0.1002
WALK_BASE_COND = 489.8
H30_RANK = 310  # rank of the checked-in structural cache
# the JAX package's base distances to the real model on the CAD study
# (BENCH_r05, skipSamples=1), by CAD-prior mode
CAD_BASE_DIST = dict(uniform=1.786, observability=1.551, geometric=1.432, geometric_obs=1.431)
CAD_STUDY_SHAPE = (1000, 36, 432)
ARM_CONFIG = os.path.join(REPO, "examples", "configs", "sevenlink_arm.yaml")
# bench.py:219-220, the fourth leg's budget
TRAJ_BUDGET = dict(globalOptSize=64, globalOptIterations=8, globalOptRestarts=1,
                   localOptIterations=3, localOptStages=5, localOptRestarts=8)
# the structural Gram of the arm with the example configuration's
# friction columns (80 inertial + Fc, Fv, offset of 7 joints)
TRAJ_STRUCTURAL_SHAPE = (14000, 1, 101)
# humanoid30's structural Gram without friction columns (the suspended leg)
SUSPENDED_STRUCTURAL_SHAPE = (72000, 1, 340)
# the JAX package's results of this leg (its optimize_trajectory on the
# CPU in f32 with this configuration, tools/jax_trajectory_record.py
# --seeds 0,1,2,3,4): bench.py's regularized -logdet(G_base/N) and base
# cond of the optimized trajectory by trajectoryOptSeed; all ended feasible
TRAJ_JAX = {
    0: (-177.05717626744678, 219.059039184322),
    1: (-169.5827445065068, 184.45712379553711),
    2: (-170.36492959161387, 153.23046562864508),
    3: (-169.51226907695113, 139.90969330016114),
    4: (-168.00865462058738, 272.650541362959),
}
# how far behind the JAX package the port may end. The augmented-Lagrangian
# stage (Adam on a max-over-time objective, best feasible point of 8 x 5
# stage ends) amplifies rounding and depends on the seed: the JAX package's
# own results spread by more than this over its seeds, so one seed against
# one figure decides nothing. The gate is on the mean over the seeds
# above, each against the same seed (PERF.md, Findings)
TRAJ_JAX_TOL = 0.05
SUSPENDED_OPTIONS = dict(  # bench.py:266-273
    floatingBase=1, floatingBaseAttachment="suspended",
    floatingBaseAttachmentFrame="crane_ft", suspendedDamping=500.0,
    useStructuralRegressor=1, randomSamples=2000, excitationFrequency=50.0,
    trajectoryPulseMin=1.0, trajectoryPulseMax=1.6, trajectoryDefaultNf=3, globalOptSize=12,
    globalOptIterations=4, localOptIterations=2, trajectoryTargetVelocity=0.8, verbose=0)


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


def walking_samples(model, n: int) -> dict:
    """bench.py's walking scenario (seed 0, its noise levels), generated
    by the port on the model's device."""
    from flobaroid_tpu_torch.simulation.scenarios import walking_contact_scenario

    t0 = time.perf_counter()
    samples, _, _ = walking_contact_scenario(
        model, N=n, freq=200.0, seed=0, torque_noise=0.05, wrench_noise=0.5)
    emit("walking_scenario", n_samples=n, device=str(model.device),
         seconds=time.perf_counter() - t0)
    return samples


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
    from flobaroid_tpu_torch.utils.helpers import is_physical_consistent

    m = idf.model
    return is_physical_consistent(idf._full_xstd()[: m.num_model_params], m.num_links)


# (name, N, B, C, run by a path of this script). The per-channel site
# runs in chunks of gramChunk = 4096 samples, B = output channels, C = the
# identified columns with tau and the contact column appended: the arm's
# N=2000 is one chunk of 7 x 82, its N=60 000 14 chunks of 4096 and a tail
# of 2656; humanoid30's walking N=13 770 is 3 chunks of 4096 x 36 x 432
# and a tail of 1482, its card-vs-CPU N=1200 one chunk, the CAD study's
# N=1000 one chunk (no contacts: the contact column is zero). The structural
# Gram is one B=1 launch of 2000 random states x rows: 14 000 x 80 (arm),
# 14 000 x 101 (the arm with friction columns, the trajectory leg),
# 72 000 x 430 (humanoid30), 72 000 x 340 (humanoid30 without friction
# columns, the suspended leg). The extra shapes are run by no path here.
KERNEL_SHAPES = [
    ("structural_B1_M14000_C80", 14000, 1, 80, True),
    ("per_channel_B7_N2000_C82", 2000, 7, 82, True),
    ("per_channel_chunk_B7_N4096_C82", 4096, 7, 82, True),
    ("per_channel_tail_B7_N2656_C82", 2656, 7, 82, True),
    ("walking_structural_B1_M72000_C430", 72000, 1, 430, True),
    ("walking_chunk_B36_N4096_C432", 4096, 36, 432, True),
    ("walking_tail_B36_N1482_C432", 1482, 36, 432, True),
    ("walking_cmp_B36_N1200_C432", 1200, 36, 432, True),
    ("cad_study_B36_N1000_C432", *CAD_STUDY_SHAPE, True),
    ("trajectory_structural_B1_M14000_C101", *TRAJ_STRUCTURAL_SHAPE, True),
    ("suspended_structural_B1_M72000_C340", *SUSPENDED_STRUCTURAL_SHAPE, True),
    ("extra_one_call_B7_N60000_C82", 60000, 7, 82, False),
    ("extra_ragged_M1037_C37", 1037, 1, 37, False),
]
CHECKED_SHAPES = {(N, B, C) for _, N, B, C, on_path in KERNEL_SHAPES if on_path}


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


def base_cond(model) -> float | None:
    """cond2 of the base regressor, sqrt(cond2) of the streamed base Gram
    over its positive eigenvalues (as bench.py computes it)."""
    Gb = getattr(model, "G_base", None)
    if Gb is None:
        return None
    ev = np.linalg.eigvalsh(np.asarray(Gb, dtype=float))
    pos = ev[ev > 0]
    return float(np.sqrt(pos.max() / pos.min())) if len(pos) else None


def run_main_path(gram, urdf: str, n: int, warm: int, device: str, label: str,
                  opt_overrides: dict | None = None, cache_miss: bool = True,
                  options: dict = BENCH_OPTIONS, make_samples=build_samples) -> dict:
    """Identification(opt, urdf, device).estimateParameters(): one cold
    pass, then `warm` passes on the same object, held to bench.py's gates.
    Launch counts and shapes are the kernel launches made within this
    call."""
    import torch

    from flobaroid_tpu_torch.identification.identifier import Identification
    from flobaroid_tpu_torch.utils.config import load_config

    opt = load_config(None, overrides={**options, **(opt_overrides or {})})
    start, start_shapes = gram.launches, Counter(gram.launch_shapes)
    t0 = time.perf_counter()
    idf = Identification(dict(opt), urdf, device=device)
    t_init = time.perf_counter() - t0
    structural_launches = gram.launches - start
    samples = make_samples(idf.model, n)
    chunk = int(opt["gramChunk"])
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
    shapes = gram.launch_shapes - start_shapes
    m = idf.model
    xb_err = float(np.linalg.norm(m.xBase - m.xBaseModel) / np.linalg.norm(m.xBaseModel))
    w = walls[1:]
    res = dict(
        n_samples=n, device=device,
        init_s=t_init, cold_s=walls[0], warm_s=w,
        warm_min_s=min(w) if w else None, warm_mean_s=float(np.mean(w)) if w else None,
        warm_max_s=max(w) if w else None,
        rows_per_s=n * m.N_OUT / min(w) if w else None,
        stage_times_s=idf.stage_times, num_base_params=m.num_base_params,
        res_error_pct=float(idf.res_error), base_param_rel_err=xb_err, base_cond=base_cond(m),
        physically_consistent=physically_consistent(idf),
        sdp_status=idf.sdp.last_status, sdp_info=idf.sdp.last_info,
        G_rows_device=str(m.G_rows.device),
        structural_launches=structural_launches, launches_per_pass=launches_per_pass,
        launch_shapes=sorted([*k, c] for k, c in shapes.items()),
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
        check(set(shapes) <= CHECKED_SHAPES,
              f"{label}: launches at {sorted(shapes)}, not all checked in phase 2")
    return res


def copy_urdf(src: str, dst_dir: str, with_cache: bool) -> str:
    os.makedirs(dst_dir, exist_ok=True)
    urdf = os.path.join(dst_dir, os.path.basename(src))
    shutil.copy(src, urdf)
    if with_cache:
        shutil.copy(src + ".regressor.npz", urdf + ".regressor.npz")
    return urdf


def run_walking_leg(gram, tmp: str) -> dict:
    """Phase 4: a humanoid30 structural cache miss on the card, then
    bench.py's second leg on the checked-in cache."""
    import torch

    from flobaroid_tpu_torch.identification.identifier import Identification
    from flobaroid_tpu_torch.utils.config import load_config

    urdf = copy_urdf(H30_URDF, os.path.join(tmp, "walk_miss"), with_cache=False)
    before, before_shapes = gram.launches, Counter(gram.launch_shapes)
    t0 = time.perf_counter()
    model = Identification(load_config(None, overrides=WALK_OPTIONS), urdf, device="cuda").model
    torch.cuda.synchronize()
    shapes = gram.launch_shapes - before_shapes
    miss = dict(seconds=time.perf_counter() - t0, launches=gram.launches - before,
                launch_shapes=sorted([*k, c] for k, c in shapes.items()),
                num_base_params=model.num_base_params,
                gram_dtype=np.dtype(model._structural_gram_dtype).name)
    emit("walking_structural_miss", **miss)
    check(dict(shapes) == {(72000, 1, 430): 1},
          f"walking structural miss: launches {dict(shapes)}, not one at 72000x1x430")
    check(model.num_base_params == H30_RANK,
          f"walking structural miss: rank {model.num_base_params} on the card, not {H30_RANK}")

    urdf = copy_urdf(H30_URDF, os.path.join(tmp, "walk"), with_cache=True)
    res = run_main_path(gram, urdf, WALK_N, 3, "cuda", "walking_N13770", cache_miss=False,
                        options=WALK_OPTIONS, make_samples=walking_samples)
    check(res["structural_launches"] == 0, "walking: the checked-in cache was not used")
    check(res["num_base_params"] == H30_RANK, f"walking: rank {res['num_base_params']}")
    check(all(k == 4 for k in res["launches_per_pass"]),
          f"walking: {res['launches_per_pass']} launches per pass, not 4")
    dres = abs(res["res_error_pct"] - WALK_RES_ERROR_PCT)
    check(dres <= 0.005, f"walking: torque residual {res['res_error_pct']} % is {dres} "
                         f"percentage points from {WALK_RES_ERROR_PCT}")
    check(res["base_param_rel_err"] < 1e-3,
          f"walking: base distance {res['base_param_rel_err']} >= 1e-3")
    check(res["base_cond"] is not None and abs(res["base_cond"] / WALK_BASE_COND - 1) <= 0.02,
          f"walking: base cond {res['base_cond']} not within 2 % of {WALK_BASE_COND}")
    return res


def run_cad_leg(gram, tmp: str) -> dict:
    """Phase 5: bench.py's third leg, `run_cad_study` on the checked-in
    suspended recording, a cold and a warm study on one Identification on
    the card, and the same study on the CPU in f64."""
    import torch

    from flobaroid_tpu_torch.identification import cad_study

    d = os.path.join(tmp, "cad")
    cad = copy_urdf(H30_URDF, d, with_cache=True)
    real, meas = (shutil.copy(f, d) for f in (H30_REAL_URDF, H30_CAD_RECORDING))
    over = dict(skipSamples=1)
    modes = list(cad_study.MODE_OVERRIDES)

    def gates(label, res):
        b = {m: res[m]["base_dist"] for m in modes}
        for m in modes:
            check(str(res[m]["status"]).startswith("optimal"), f"{label}: {m} ended {res[m]['status']}")
            check(res[m]["res_error_pct"] < 5.0, f"{label}: {m} residual {res[m]['res_error_pct']} %")
            check(abs(b[m] / CAD_BASE_DIST[m] - 1) <= 0.03,
                  f"{label}: {m} base distance {b[m]} not within 3 % of {CAD_BASE_DIST[m]}")
        check(b["uniform"] > b["observability"] > 0.98 * b["geometric"]
              and abs(b["geometric"] - b["geometric_obs"]) < 0.15 * b["geometric"],
              f"{label}: ordering of the base distances {b}")

    start, start_shapes = gram.launches, Counter(gram.launch_shapes)
    t0 = time.perf_counter()
    idf = cad_study.study_identification(cad, real, meas, over, device="cuda")
    init_s = time.perf_counter() - t0
    check(gram.launches == start, "cad study: the checked-in structural cache was not used")
    check(idf.model.num_base_params == H30_RANK, f"cad study: rank {idf.model.num_base_params}")
    out = {}
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        res = cad_study.run_cad_study(cad, real, meas, idf=idf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[label] = res
        consistent = physically_consistent(idf)
        emit(f"cad_study_{label}", device="cuda", n_samples=idf.data.num_used_samples,
             init_s=init_s, wall_s=wall, stage_times_last_mode_s=idf.stage_times,
             sdp_s={m: res[m]["sdp_s"] for m in modes},
             newton_iters={m: res[m]["newton_iters"] for m in modes},
             status={m: res[m]["status"] for m in modes},
             base_dist={m: res[m]["base_dist"] for m in modes},
             std_dist={m: res[m]["std_dist"] for m in modes},
             res_error_pct={m: res[m]["res_error_pct"] for m in modes},
             apriori=res["apriori"], launches={m: res[m]["launches"] for m in modes},
             physically_consistent=consistent, table=cad_study.format_table(res))
        gates(f"cad study ({label})", res)
        check([res[m]["launches"] for m in modes] == [1, 0, 0, 0],
              f"cad study ({label}): launches by mode {[res[m]['launches'] for m in modes]}: "
              f"the modes must share one regressor pass")
        check(consistent, f"cad study ({label}): not physically consistent")
    shapes = gram.launch_shapes - start_shapes
    check(dict(shapes) == {CAD_STUDY_SHAPE: 2} and CAD_STUDY_SHAPE in CHECKED_SHAPES,
          f"cad study: launches {dict(shapes)}, not one per study at {CAD_STUDY_SHAPE}")
    check(idf.model.G_rows.device.type == "cuda", f"cad study: G_rows on {idf.model.G_rows.device}")

    # the same study by the port on the CPU in f64: what the card's f32
    # Grams change
    before = gram.launches
    t0 = time.perf_counter()
    cpu = cad_study.run_cad_study(cad, real, meas, dict(over, computeDtype="float64"),
                                  device="cpu")
    check(gram.launches == before, "cad study on the CPU launched the kernel")
    gates("cad study (cpu f64)", cpu)
    diff = {m: abs(out["cold"][m]["base_dist"] / cpu[m]["base_dist"] - 1) for m in modes}
    emit("cad_study_cpu_f64", wall_s=time.perf_counter() - t0,
         base_dist={m: cpu[m]["base_dist"] for m in modes},
         std_dist={m: cpu[m]["std_dist"] for m in modes},
         newton_iters={m: cpu[m]["newton_iters"] for m in modes},
         card_base_dist_rel_diff=diff)
    check(max(diff.values()) <= 0.01, f"cad study: card vs cpu f64 base distances differ by {diff}")
    return out


def trajectory_dopt(model, opt: dict, spec, x) -> tuple[float, float]:
    """bench.py:187-209's `dopt_of` through the port's
    Model.computeRegressors: the regularized -logdet(G_base/N) and the
    base cond of one period of the trajectory x at its own pulsation."""
    import torch

    from flobaroid_tpu_torch.data import Data
    from flobaroid_tpu_torch.excitation.trajectory import fourier_traj

    freq = float(opt["excitationFrequency"])
    tt = np.arange(max(int(2 * np.pi / x[0] * freq), 16)) / freq
    Q, V, A = (a.numpy() for a in
               fourier_traj(spec, torch.as_tensor(np.asarray(x), dtype=torch.float64), tt))
    N = len(tt)
    samples = {"positions": Q, "velocities": V, "accelerations": A,
               "torques": np.zeros((N, model.num_dofs)), "times": tt,
               "frequency": np.float64(freq)}
    sim = dict(simulateTorques=True, skipSamples=0, startOffset=0)
    d = Data({**opt, **sim})
    d.init_from_data(samples)
    old = {k: model.opt[k] for k in sim}
    model.opt.update(sim)
    try:
        model.computeRegressors(d)
    finally:
        model.opt.update(old)
    ev = np.linalg.eigvalsh(model.YBase.T @ model.YBase / N)
    return (float(-np.sum(np.log(ev + 1e-4 * ev[-1]))),
            float(np.sqrt(ev[-1] / max(ev[0], 1e-300))))


def first_generation(spec, cfg: dict) -> np.ndarray:
    """The candidates `optimize_trajectory` evaluates first: its rng
    draws the initial candidate, then the global search draws its start
    mean and the population around it."""
    from flobaroid_tpu_torch.excitation.optimizer import build_bounds, initial_candidate

    rng = np.random.default_rng(int(cfg.get("trajectoryOptSeed", 0)))
    initial_candidate(spec, cfg, rng)
    lo, hi = build_bounds(spec, cfg)
    mean = np.clip(initial_candidate(spec, cfg, rng), lo, hi)
    pop = int(cfg["globalOptSize"])
    X = np.clip(mean + 0.3 * (hi - lo) * rng.standard_normal((pop, spec.dim)), lo, hi)
    X[0] = mean
    return X


def trajectory_leg_config(seed: int = 0) -> tuple[dict, dict]:
    """The example configuration of the arm with capsule constraints and
    the exact convex-hull verification of the result (the mode the JAX
    package's bench leg verifies with), and the same with bench.py's
    fourth-leg budget and the optimizer's seed."""
    from flobaroid_tpu_torch.utils.config import load_config

    opt = load_config(ARM_CONFIG, overrides=dict(
        verbose=0, trajectoryOptSeed=seed, checkCollisions=1, collisionMode="convex"))
    return opt, dict(opt, **TRAJ_BUDGET)


def run_trajectory_leg(gram, tmp: str) -> dict:
    """Phase 6: bench.py's fourth leg on the checked-in 7-DOF arm, once
    per seed of TRAJ_JAX."""
    import torch

    from flobaroid_tpu_torch.excitation.objective import TrajectoryObjective
    from flobaroid_tpu_torch.excitation.optimizer import initial_candidate, optimize_trajectory
    from flobaroid_tpu_torch.model import Model

    urdf = copy_urdf(ARM_URDF, os.path.join(tmp, "traj"), with_cache=False)
    opt, _ = trajectory_leg_config()
    start_shapes = Counter(gram.launch_shapes)
    t0 = time.perf_counter()
    model = Model(opt, urdf, device="cuda")
    init_s = time.perf_counter() - t0
    shapes = gram.launch_shapes - start_shapes
    check(dict(shapes) == {TRAJ_STRUCTURAL_SHAPE: 1} and TRAJ_STRUCTURAL_SHAPE in CHECKED_SHAPES,
          f"trajectory: launches {dict(shapes)} at Model init, not one at {TRAJ_STRUCTURAL_SHAPE}")

    runs = {}
    for seed, (jax_f, jax_c) in TRAJ_JAX.items():
        _, cfg = trajectory_leg_config(seed)
        t0 = time.perf_counter()
        x, spec, obj, info = optimize_trajectory(model, cfg)
        wall = time.perf_counter() - t0
        f, c = trajectory_dopt(model, opt, spec, x)
        x0 = initial_candidate(spec, cfg, np.random.default_rng(seed))
        f0, c0 = trajectory_dopt(model, opt, spec, x0)
        fv0, g0, _ = obj.evaluate(x0)
        generations = int(cfg["globalOptIterations"]) * int(cfg["globalOptRestarts"])
        al_steps = int(cfg["localOptStages"]) * int(cfg["localOptIterations"]) * 40
        res = dict(
            device="cuda", seed=seed, model_init_s=init_s, wall_s=wall,
            t_global_s=info["t_global_s"], t_local_s=info["t_local_s"],
            ms_per_cem_generation=1e3 * info["t_global_s"] / generations,
            ms_per_al_step=1e3 * info["t_local_s"] / al_steps, candidates=int(cfg["globalOptSize"]),
            al_restarts=int(cfg["localOptRestarts"]), al_steps=al_steps,
            n_samples=obj.num_samples, n_variables=spec.dim,
            n_collision_pairs=info["n_collision_pairs"], num_base_params=model.num_base_params,
            mesh_collision_ok=info.get("mesh_collision_ok"), t_mesh_s=info.get("t_mesh_s"),
            backoff_ran="dopt_before_backoff" in info,
            dopt_backoff_loss_pct=info.get("dopt_backoff_loss_pct"), card=gpu_name_power(),
            neg_logdet=f, base_cond=c, feasible=bool(info["feasible"]),
            max_violation=info["max_violation"], f=info["f"], pulse=float(x[0]),
            initial=dict(neg_logdet=f0, base_cond=c0, feasible=obj.feasible(g0),
                         max_violation=float(np.max(g0)), f=fv0),
            jax_package_cpu=dict(neg_logdet=jax_f, base_cond=jax_c),
            launch_shapes=sorted([*k, n] for k, n in shapes.items()),
        )
        emit("trajectory_dopt", **res)
        check(res["mesh_collision_ok"] is not None,
              f"trajectory, seed {seed}: the exact-mesh verification did not run")
        check(res["feasible"], f"trajectory, seed {seed}: not feasible "
                               f"(max violation {info['max_violation']}, "
                               f"mesh_collision_ok {res['mesh_collision_ok']})")
        # the initial candidates are infeasible (violations of 2-3), so
        # only the objective value must fall at every seed; the D-optimality
        # of the feasible result must beat the start's at seed 0
        check(info["f"] < fv0, f"trajectory, seed {seed}: f {info['f']} not below the "
                               f"initial candidate's {fv0}")
        check(seed != 0 or f < f0,
              f"trajectory: neg_logdet {f} not below the initial candidate's {f0}")
        runs[seed] = dict(res, spec=spec, obj=obj, cfg=cfg)
    mean = float(np.mean([r["neg_logdet"] for r in runs.values()]))
    jax_mean = float(np.mean([f for f, _ in TRAJ_JAX.values()]))
    emit("trajectory_dopt_seeds", seeds=list(runs), neg_logdet=[r["neg_logdet"] for r in runs.values()],
         jax_package_cpu=[f for f, _ in TRAJ_JAX.values()], mean=mean, jax_mean=jax_mean,
         behind_jax_pct=100 * (mean - jax_mean) / abs(jax_mean),
         wall_s=[r["wall_s"] for r in runs.values()])
    check(mean <= jax_mean + TRAJ_JAX_TOL * abs(jax_mean),
          f"trajectory: mean neg_logdet {mean} over seeds {list(runs)} worse than the JAX "
          f"package's {jax_mean} by more than {100 * TRAJ_JAX_TOL:g} %")

    # the first generation of seed 0 on the card against the port on the
    # CPU in f64, on the structural cache the model above wrote (one
    # projection)
    spec, obj, cfg = (runs[0][k] for k in ("spec", "obj", "cfg"))
    X = first_generation(spec, cfg)
    fd, gd, _ = obj.evaluate_batch(X)
    cpu_model = Model(dict(opt, computeDtype="float64"), urdf, device="cpu")
    check(cpu_model.num_base_params == model.num_base_params
          and np.array_equal(cpu_model.Pb, model.Pb), "trajectory: the CPU model's projection differs")
    cpu_obj = TrajectoryObjective(
        cpu_model, cfg, spec, extra_constraints_fn=obj.extra_constraints_fn,
        n_extra_constraints=runs[0]["n_collision_pairs"] or None, dtype=torch.float64)
    cpu_obj._dopt_scale = obj.dopt_scale
    t0 = time.perf_counter()
    fc, gc, _ = cpu_obj.evaluate_batch(X)
    cmp = dict(candidates=len(X), f_rel_diff=float(np.abs(fd - fc).max() / np.abs(fc).max()),
               g_abs_diff=float(np.abs(gd - gc).max()), cpu_f64_seconds=time.perf_counter() - t0)
    emit("trajectory_first_generation_vs_cpu_f64", **cmp)
    check(cmp["f_rel_diff"] <= 1e-3, f"trajectory: first generation differs by {cmp['f_rel_diff']}")
    return runs


def run_suspended_leg(gram, tmp: str) -> tuple[dict, object, np.ndarray]:
    """Phase 7: the suspended humanoid30 objective (bench.py:266-273's
    options), forward on 12 candidates and one augmented-Lagrangian
    gradient for 2 restarts, against the port on the CPU in f64. Returns
    the result, the card's objective and the candidates."""
    import torch

    from flobaroid_tpu_torch.excitation.objective import TrajectoryObjective
    from flobaroid_tpu_torch.excitation.optimizer import build_bounds, initial_candidate
    from flobaroid_tpu_torch.excitation.trajectory import FourierSpec
    from flobaroid_tpu_torch.model import Model
    from flobaroid_tpu_torch.utils.config import load_config

    # these options identify no friction (P = 340): the checked-in cache
    # (P = 430) does not serve them, so the first model computes the
    # structural Gram (one launch) and the second reads what it wrote
    urdf = copy_urdf(H30_URDF, os.path.join(tmp, "suspended"), with_cache=False)
    opt = load_config(None, overrides=SUSPENDED_OPTIONS)
    n_candidates, n_restarts = 12, 2
    rng = np.random.default_rng(0)
    X = LAM = RHO = Pb = None
    out = {}
    start_shapes = Counter(gram.launch_shapes)
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = Model(dict(opt, computeDtype=str(dtype).replace("torch.", "")), urdf, device=dev)
        lims = model.limits
        spec = FourierSpec(nf=(int(opt["trajectoryDefaultNf"]),) * model.num_dofs, limits=tuple(
            (float(lims[j]["lower"]), float(lims[j]["upper"])) for j in model.jointNames))
        t0 = time.perf_counter()
        obj = TrajectoryObjective(model, dict(opt), spec, dtype=dtype)
        build_s = time.perf_counter() - t0
        if X is None:
            lo, hi = build_bounds(spec, opt)
            x0 = initial_candidate(spec, opt, rng)
            X = np.clip(x0 + 0.05 * (hi - lo) * rng.standard_normal((n_candidates, spec.dim)), lo, hi)
            X[0] = x0
        obj.calibrate_scale(X[0])

        def timed(fn):
            t0 = time.perf_counter()
            r = fn()
            if dev == "cuda":
                torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        (f, g, _), forward_s = timed(lambda: obj.evaluate_batch(X))
        if LAM is None:
            LAM = np.abs(rng.standard_normal((n_restarts, g.shape[1])))
            RHO = np.full(n_restarts, 10.0)
        # the restarts start off q0 = 0 (X[0]), where the range's min()
        # ties and f32 and f64 may take different sides of the kink
        (v, grad), al_step_s = timed(
            lambda: obj.al_value_and_grad(X[1:1 + n_restarts], LAM, RHO))
        check(Pb is None or np.array_equal(Pb, model.Pb),
              "suspended objective: the CPU model's projection differs")
        Pb = model.Pb
        out[dev] = dict(obj=obj, f=f, g=g, v=v, grad=grad, forward_s=forward_s, al_step_s=al_step_s,
                        build_s=build_s, n_samples=obj.num_samples, n_variables=spec.dim,
                        num_base_params=model.num_base_params)
    d, c = out["cuda"], out["cpu"]
    shapes = gram.launch_shapes - start_shapes
    check(dict(shapes) == {SUSPENDED_STRUCTURAL_SHAPE: 1}
          and SUSPENDED_STRUCTURAL_SHAPE in CHECKED_SHAPES,
          f"suspended objective: launches {dict(shapes)}, not one at {SUSPENDED_STRUCTURAL_SHAPE}")
    grad_rel = np.linalg.norm(d["grad"] - c["grad"], axis=1) / np.linalg.norm(c["grad"], axis=1)
    res = dict(
        device="cuda", candidates=n_candidates, al_restarts=n_restarts, n_samples=d["n_samples"],
        n_variables=d["n_variables"], num_base_params=d["num_base_params"],
        objective_build_s=d["build_s"], forward_s=d["forward_s"],
        forward_ms_per_integrator_step=1e3 * d["forward_s"] / d["n_samples"],
        al_step_s=d["al_step_s"], cpu_f64_forward_s=c["forward_s"], cpu_f64_al_step_s=c["al_step_s"],
        f=d["f"].tolist(), max_violation=d["g"].max(axis=1).tolist(),
        f_rel_diff=float(np.abs(d["f"] - c["f"]).max() / np.abs(c["f"]).max()),
        al_value_rel_diff=float(np.abs(d["v"] - c["v"]).max() / np.abs(c["v"]).max()),
        al_grad_rel_diff=grad_rel.tolist(),
        launch_shapes=sorted([*k, n] for k, n in shapes.items()),
    )
    emit("suspended_objective", **res)
    check(all(np.all(np.isfinite(d[k])) for k in ("f", "g", "v", "grad")),
          "suspended objective: non-finite values or gradients")
    check(np.all(np.linalg.norm(d["grad"], axis=1) > 0), "suspended objective: a zero gradient")
    check(np.all(d["f"] < 1e4), "suspended objective: a candidate's Cholesky failed")
    check(res["f_rel_diff"] <= 1e-3 and res["al_value_rel_diff"] <= 1e-3,
          f"suspended objective: card vs cpu f64 {res['f_rel_diff']}, {res['al_value_rel_diff']}")
    check(float(grad_rel.max()) <= 1e-3,
          f"suspended objective: AL gradient differs from the cpu f64 one by {grad_rel.tolist()}")
    return res, d["obj"], X


def run_simulator_leg(gram, tmp: str) -> dict:
    """Phase 8: the port makes the recording it was given for the CAD
    study, then identifies it with the geometric CAD prior."""
    from flobaroid_tpu_torch.identification import cad_study
    from flobaroid_tpu_torch.simulation.simulator import MEASUREMENT_KEYS

    d = os.path.join(tmp, "simulate")
    cad = copy_urdf(H30_URDF, d, with_cache=True)
    real = shutil.copy(H30_REAL_URDF, d)
    meas_npz = os.path.join(d, "suspended_measurements.npz")
    t0 = time.perf_counter()
    meas = cad_study.generate_suspended_measurements(
        real, meas_npz, duration=40.0, freq=50.0, seed=0, device="cuda")
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = cad_study.generate_suspended_measurements(
        real, os.path.join(d, "cpu_f64.npz"), duration=40.0, freq=50.0, seed=0, device="cpu",
        overrides=dict(computeDtype="float64"))
    cpu_seconds = time.perf_counter() - t0
    series = [k for k in sorted(MEASUREMENT_KEYS) if k != "contacts"]
    # difference of each series over its largest magnitude on the CPU
    diff = {k: float(np.abs(np.asarray(meas[k], float) - np.asarray(ref[k], float)).max()
                     / max(np.abs(np.asarray(ref[k], float)).max(), 1e-300)) for k in series}
    recorded = dict(np.load(H30_CAD_RECORDING, allow_pickle=True))
    to_recording = {k: float(np.abs(np.asarray(meas[k], float) - np.asarray(recorded[k], float)).max()
                             / max(np.abs(np.asarray(recorded[k], float)).max(), 1e-300))
                    for k in series if np.shape(recorded[k]) == np.shape(meas[k])}
    n = len(meas["times"])
    emit("simulate_suspended", device="cuda", n_samples=n, seconds=seconds,
         ms_per_sample=1e3 * seconds / n, cpu_f64_seconds=cpu_seconds,
         rel_diff_vs_cpu_f64=diff, rel_diff_vs_checked_in_recording=to_recording)
    check(set(meas) == MEASUREMENT_KEYS, f"simulator: keys {sorted(set(meas) ^ MEASUREMENT_KEYS)}")
    check(all(np.all(np.isfinite(np.asarray(meas[k], float))) for k in series),
          "simulator: non-finite measurements")
    # the card integrates and simulates in f32: the base motion and the
    # torques within 2e-3 of their largest magnitude on the CPU in f64
    for k in ("base_rpy", "base_velocity", "base_position", "torques", "positions", "velocities"):
        check(diff[k] <= 2e-3, f"simulator: {k} differs from the CPU in f64 by {diff[k]}")

    before = gram.launches
    idf = cad_study.study_identification(cad, real, meas_npz, dict(skipSamples=1), device="cuda")
    t0 = time.perf_counter()
    res = cad_study.run_cad_study(cad, real, meas_npz, idf=idf,
                                  modes={"geometric": cad_study.MODE_OVERRIDES["geometric"]})
    geo = res["geometric"]
    emit("identify_simulated_recording", device="cuda", n_samples=idf.data.num_used_samples,
         wall_s=time.perf_counter() - t0, launches_with_init=gram.launches - before, **geo,
         apriori=res["apriori"], jax_package_base_dist=CAD_BASE_DIST["geometric"])
    check(str(geo["status"]).startswith("optimal"), f"simulator: identify ended {geo['status']}")
    check(abs(geo["base_dist"] / CAD_BASE_DIST["geometric"] - 1) <= 0.03,
          f"simulator: base distance {geo['base_dist']} not within 3 % of "
          f"{CAD_BASE_DIST['geometric']}")
    return diff


# ----------------------------------------------------------------------
# the exact-mesh tier, the posture optimizer, the Lagrangian oracle and
# the model analyses
# ----------------------------------------------------------------------
# the small arm configuration of tests/test_torch_mesh_backoff.py for the
# back-off with the stand-in geometry (minTolConstr 0: under the default
# 1 cm tolerance the tightened constraint still counts as met at the start)
BACKOFF_OPTIONS = dict(
    floatingBase=0, useStructuralRegressor=1, randomSamples=2000, checkCollisions=1,
    collisionMode="convex", minTolConstr=0.0, excitationFrequency=25.0,
    trajectoryPulseMin=1.0, trajectoryPulseMax=1.5, trajectoryPulseInit=1.2,
    trajectoryDefaultNf=1, globalOptSize=8, globalOptIterations=2, globalOptRestarts=1,
    localOptIterations=1, localOptStages=2, verbose=0)
BACKOFF_MAX_LOSS = 0.05  # tests/test_mesh_backoff.py's bound on the D-optimality loss
# the full-width verifier's card-vs-CPU gate: a tenth of verify()'s 1e-3 m
VERIFIER_TOL_M = 1e-4
VERIFIER_CPU_CANDIDATES = 2  # of the suspended leg's 12, checked on the CPU too
ARM_STRUCTURAL_SHAPE = (14000, 1, 80)  # the arm's structural Gram without friction
# the JAX package's figures for humanoid30 with WALK_OPTIONS on the
# checked-in cache (flobaroid_tpu.model.Model on the CPU, float32 compute:
# structural_identifiability() and sensor_placement_study(H30_SENSOR_SETS,
# n_samples=2000))
H30_SENSOR_SETS = {"left_foot": ["LLeg_6"], "left_hand": ["LArm_7"]}
H30_IDENTIFIABILITY_JAX = {
    "individually_identifiable": 83,
    "individually_identifiable_params": [
        21, 25, 26, 35, 38, 45, 46, 51, 53, 55, 56, 57, 58, 72, 75, 76, 78, 81, 85, 86, 91,
        95, 96, 98, 101, 105, 106, 115, 118, 122, 123, 124, 125, 126, 128, 142, 145, 146, 148,
        151, 155, 156, 161, 165, 166, 168, 171, 175, 176, 185, 188, 192, 193, 194, 195, 196,
        198, 202, 205, 208, 215, 216, 221, 225, 226, 231, 235, 236, 245, 248, 272, 275, 278,
        285, 286, 291, 295, 296, 301, 305, 306, 315, 318],
    "base_directions": 220, "null_directions": 120, "n_inertial_params": 340,
}
H30_SENSOR_PLACEMENT_JAX = {
    "baseline_rank": 220, "n_inertial_params": 340, "null_directions": 120,
    "sets": {"left_foot": {"links": ["LLeg_6"], "rank": 223, "gain": 3},
             "left_hand": {"links": ["LArm_7"], "rank": 223, "gain": 3}},
}
# the geometries of tests/test_collision_mesh.py: two thin plates whose
# corners overlap at q = 0; a U-channel mesh (non-convex) with a bar that
# swings into its cavity; a world cage around both
_INERTIAL = ('<inertial><mass value="{m}"/><inertia ixx="{i}" iyy="{i}" izz="{i}" '
             'ixy="0" ixz="0" iyz="0"/></inertial>')
_REVOLUTE = ('<joint name="{n}" type="revolute"><parent link="{p}"/><child link="{c}"/>'
             '<origin xyz="{xyz}"/><axis xyz="0 0 1"/>'
             '<limit lower="-3.14" upper="3.14" effort="10" velocity="2"/></joint>')
PLATES_URDF = (
    '<robot name="plates">'
    '<link name="base_plate">' + _INERTIAL.format(m=1, i=0.1)
    + '<visual><geometry><box size="1.0 1.0 0.02"/></geometry></visual></link>'
    '<link name="mid">' + _INERTIAL.format(m=0.5, i=0.01) + '</link>'
    '<link name="plate_b">' + _INERTIAL.format(m=1, i=0.1)
    + '<visual><geometry><box size="1.0 1.0 0.02"/></geometry></visual></link>'
    + _REVOLUTE.format(n="j1", p="base_plate", c="mid", xyz="0.95 0.95 0")
    + _REVOLUTE.format(n="j2", p="mid", c="plate_b", xyz="0 0 0") + '</robot>')
CHANNEL_URDF = (
    '<robot name="channel">'
    '<link name="channel">' + _INERTIAL.format(m=2, i=0.1)
    + '<visual><geometry><mesh filename="uchannel.stl"/></geometry></visual></link>'
    '<link name="mid">' + _INERTIAL.format(m=0.1, i=0.01) + '</link>'
    '<link name="bar">' + _INERTIAL.format(m=0.5, i=0.01)
    + '<visual><origin xyz="0.28 0 0"/><geometry><box size="0.1 0.1 0.1"/></geometry></visual>'
    '</link>'
    + _REVOLUTE.format(n="j1", p="channel", c="mid", xyz="0 0 0.2")
    + _REVOLUTE.format(n="j2", p="mid", c="bar", xyz="0 0 0") + '</robot>')
WORLD_URDF = (
    '<robot name="room"><link name="cage">' + _INERTIAL.format(m=100, i=1)
    + '<visual><origin xyz="0 0 0.2"/><geometry><box size="2.0 2.0 2.0"/></geometry></visual>'
    '</link></robot>')


def write_channel_stl(path: str) -> None:
    """Binary STL of the U-channel: a base slab and two walls, each a
    12-triangle box."""
    import struct

    from flobaroid_tpu_torch.collision_mesh import box_triangles

    tris = []
    for center, half in (((0, 0, -0.05), (0.5, 0.5, 0.05)), ((0.4, 0, 0.2), (0.1, 0.5, 0.2)),
                         ((-0.4, 0, 0.2), (0.1, 0.5, 0.2))):
        v, t = box_triangles(center, half, np.eye(3))
        tris.append(v[t])
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        tris = np.concatenate(tris)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            n = np.cross(t[1] - t[0], t[2] - t[0])
            f.write(struct.pack("<12fH", *(n / np.linalg.norm(n)), *t[0], *t[1], *t[2], 0))


def run_regressor_rate() -> dict:
    """bench.py:397-419's `regressor_rows_per_sec`: `regressor_batch` alone
    on the arm's 2000 random states in f32, 20 repetitions, each input
    perturbed and each output reduced, timed with CUDA events."""
    import torch

    from flobaroid_tpu_torch.device import apply_precision_policy
    from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
    from flobaroid_tpu_torch.models.urdf import load_urdf

    apply_precision_policy()
    tree = load_urdf(ARM_URDF)
    eng = DynamicsEngine(tree)
    n, reps = 2000, 20
    s = build_samples(SimpleNamespace(limits=tree.joint_limits(use_deg=False),
                                      jointNames=list(tree.dof_names)), n)
    Q, V, A = (torch.as_tensor(s[k], dtype=torch.float32, device="cuda")
               for k in ("positions", "velocities", "accelerations"))

    def regr_sum(i):
        Y = eng.regressor_batch(Q + 1e-6 * i, V, A)
        return (Y * Y).sum()

    for i in range(3):
        regr_sum(i)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        out = regr_sum(i)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    res = dict(n_samples=n, reps=reps, dtype="float32", rows_per_rep=n * eng.num_dofs,
               ms_per_rep=ms / reps, regressor_rows_per_sec=reps * n * eng.num_dofs / (ms / 1e3),
               checksum=float(out), card=gpu_name_power())
    emit("regressor_rows_per_sec", **res)
    check(np.isfinite(res["checksum"]), "regressor rate: non-finite regressor")
    return res


class StandInVerifier:
    """The exact-geometry stand-in of tests/test_mesh_backoff.py (the
    port's tests use this one): for the pair whose clearance varies most
    over the first verified trajectory, the 'mesh' sits delta inside the
    capsule surface, delta chosen so that pair violates by 2 mm; every
    other pair is clear. Its clearances are the capsule model's on the CPU
    in f64. Same constructor and `verify` as MeshCollisionVerifier."""

    geometry = None

    def __init__(self, tree, engine, config, capsule_model, world_tree=None, *, device="cuda"):
        self.cm = capsule_model
        self.pair_names = capsule_model.pair_names

    @property
    def num_pairs(self):
        return len(self.pair_names)

    def verify(self, Q, base_rot=None, base_pos=None, step=1, tol=1e-3):
        import torch

        cm = self.cm
        D = cm.distances(torch.as_tensor(np.asarray(Q)[::step], dtype=torch.float64)).numpy()
        D = D + np.asarray(cm.margins)[None, :]
        if StandInVerifier.geometry is None:
            spread = D.max(axis=0) - D.min(axis=0)
            j = int(np.argmax(spread))
            check(spread[j] > 0.01, "stand-in geometry: no configuration-dependent pair")
            StandInVerifier.geometry = (j, float(D[:, j].min()) + 0.002)
        j, delta = StandInVerifier.geometry
        mesh_j = float(D[:, j].min()) - delta
        return (False, [(self.pair_names[j], mesh_j)]) if mesh_j < tol else (True, [])


def run_mesh_backoff_leg(gram, tmp: str) -> dict:
    """The mesh back-off (`_mesh_backoff_refine`) on the card with the
    stand-in geometry on the arm: it must end verified and lose at most
    5 % of the D-optimality."""
    from flobaroid_tpu_torch import collision_mesh
    from flobaroid_tpu_torch.excitation.optimizer import optimize_trajectory
    from flobaroid_tpu_torch.model import Model
    from flobaroid_tpu_torch.utils.config import load_config

    urdf = copy_urdf(ARM_URDF, os.path.join(tmp, "backoff"), with_cache=False)
    opt = load_config(None, overrides=BACKOFF_OPTIONS)
    start_shapes = Counter(gram.launch_shapes)
    model = Model(dict(opt), urdf, device="cuda")
    shapes = gram.launch_shapes - start_shapes
    check(dict(shapes) == {ARM_STRUCTURAL_SHAPE: 1} and ARM_STRUCTURAL_SHAPE in CHECKED_SHAPES,
          f"mesh back-off: launches {dict(shapes)} at Model init, "
          f"not one at {ARM_STRUCTURAL_SHAPE}")
    real = collision_mesh.MeshCollisionVerifier
    collision_mesh.MeshCollisionVerifier = StandInVerifier
    StandInVerifier.geometry = None
    try:
        t0 = time.perf_counter()
        x, spec, obj, info = optimize_trajectory(model, dict(opt), rng=np.random.default_rng(4))
        wall = time.perf_counter() - t0
    finally:
        collision_mesh.MeshCollisionVerifier = real
    ran = "dopt_before_backoff" in info
    loss = ((info["dopt_after_backoff"] - info["dopt_before_backoff"])
            / abs(info["dopt_before_backoff"])) if ran else None
    res = dict(device="cuda", wall_s=wall, t_local_s=info["t_local_s"], t_mesh_s=info["t_mesh_s"],
               backoff_ran=ran, mesh_collision_ok=info.get("mesh_collision_ok"),
               dopt_before_backoff=info.get("dopt_before_backoff"),
               dopt_after_backoff=info.get("dopt_after_backoff"),
               dopt_backoff_loss_pct=info.get("dopt_backoff_loss_pct"), feasible=info["feasible"],
               n_samples=obj.num_samples, card=gpu_name_power())
    emit("mesh_backoff_stand_in", **res)
    check(ran, "mesh back-off: the stand-in geometry triggered no back-off")
    check(bool(info.get("mesh_collision_ok")) and info["feasible"],
          f"mesh back-off: ended with mesh_collision_ok {info.get('mesh_collision_ok')}, "
          f"feasible {info['feasible']}")
    check(loss < BACKOFF_MAX_LOSS, f"mesh back-off: D-optimality loss {loss} >= {BACKOFF_MAX_LOSS}")
    return res


def run_mesh_verifier_leg(sus_obj, X) -> dict:
    """`MeshCollisionVerifier` at humanoid30's full width (34 links, box
    geometry, the capsule model's pairs less those overlapping at the zero
    pose, as optimize_trajectory builds them) over the suspended leg's 12
    candidates at collisionCheckStep 1: one call over all samples on the
    card; the first candidates again on the CPU (the port in f32),
    clearances within 1e-4 m and identical verdicts."""
    import torch

    from flobaroid_tpu_torch.collision import CollisionModel
    from flobaroid_tpu_torch.collision_mesh import MeshCollisionVerifier

    model = sus_obj.model
    cfg = dict(sus_obj.config, collisionMode="box")
    cm = CollisionModel(model.tree, model.engine, cfg)
    zero = [list(p) for p, _ in cm.find_colliding_at_zero()]
    cm = CollisionModel(model.tree, model.engine, dict(cfg, ignoreLinkPairsForCollision=zero))
    t0 = time.perf_counter()
    Q, BR, BP = sus_obj.kinematics_batch(X)
    kin_s = time.perf_counter() - t0
    K, N = Q.shape[:2]
    flat = [a.reshape(K * N, *a.shape[2:]) for a in (Q, BR, BP)]
    out = {}
    for dev in ("cuda", "cpu"):
        ver = MeshCollisionVerifier(model.tree, model.engine, cfg, cm, device=dev)
        n = (K if dev == "cuda" else VERIFIER_CPU_CANDIDATES) * N
        if dev == "cuda":  # first call: the solver libraries' start-up
            ver.min_clearances(flat[0][:N], base_rot=flat[1][:N], base_pos=flat[2][:N])
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        D = ver.min_clearances(flat[0][:n], base_rot=flat[1][:n], base_pos=flat[2][:n],
                               per_sample=True)
        seconds = time.perf_counter() - t0
        # verify()'s verdict of each candidate (box geometry has no native
        # refinement): the pairs whose clearance falls below its 1e-3 m
        bad = [sorted(np.nonzero(D[i * N:(i + 1) * N].min(axis=0) < 1e-3)[0].tolist())
               for i in range(n // N)]
        out[dev] = dict(ver=ver, D=D, seconds=seconds, bad=bad, samples=n)
    c, g = out["cpu"], out["cuda"]
    ok0, bad0 = g["ver"].verify(Q[0], base_rot=BR[0], base_pos=BP[0])
    n_cpu = c["samples"]
    diff = float(np.abs(g["D"][:n_cpu] - c["D"]).max())
    same = g["bad"][:VERIFIER_CPU_CANDIDATES] == c["bad"]
    res = dict(pairs=g["ver"].num_pairs, self_pairs=len(g["ver"].self_pairs),
               world_pairs=len(g["ver"].world_pairs), zero_pose_pairs_ignored=len(zero),
               candidates=K, samples_per_candidate=N,
               samples_cuda=g["samples"], problems_cuda=g["samples"] * g["ver"].num_pairs,
               seconds_cuda=g["seconds"], samples_cpu_f32=n_cpu, seconds_cpu_f32=c["seconds"],
               kinematics_s=kin_s, max_abs_clearance_diff_m=diff, identical_verdicts=same,
               violating_pairs_by_candidate=[len(b) for b in g["bad"]],
               min_clearance_m=float(g["D"].min()), card=gpu_name_power())
    emit("mesh_verifier_humanoid30", **res)
    check(np.all(np.isfinite(g["D"])), "mesh verifier: non-finite clearances on the card")
    check(diff <= VERIFIER_TOL_M, f"mesh verifier: card vs cpu clearances differ by {diff} m")
    check(same, "mesh verifier: the card's verdicts differ from the CPU's")
    # verify() of one candidate against the clearances of the batched call,
    # leaving out pairs within 1e-5 m of its threshold (rounding decides them)
    mins0 = g["D"][:N].min(axis=0)
    clear_cut = np.abs(mins0 - 1e-3) > 1e-5
    flagged = np.zeros(len(mins0), dtype=bool)
    flagged[[g["ver"].pair_names.index(p) for p, _ in bad0]] = True
    check(np.array_equal(flagged[clear_cut], (mins0 < 1e-3)[clear_cut])
          and ok0 == (not flagged.any()), "mesh verifier: verify() disagrees with the clearances")
    return dict(res, ver=g["ver"], Q=flat[0], BR=flat[1], BP=flat[2])


def run_mesh_geometry_checks(tmp: str) -> dict:
    """The plates and the U-channel of tests/test_collision_mesh.py on the
    card: `convex` rejects the overlapping plates and accepts the 45-degree
    pose; `full` rejects the bar contained in the world cage and accepts
    the bar in the channel's cavity through the native library."""
    from flobaroid_tpu_torch import native_meshdist
    from flobaroid_tpu_torch.collision import CollisionModel
    from flobaroid_tpu_torch.collision_mesh import MeshCollisionVerifier
    from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
    from flobaroid_tpu_torch.models.urdf import load_urdf

    d = os.path.join(tmp, "geometry")
    os.makedirs(d, exist_ok=True)
    paths = {}
    for name, text in (("plates", PLATES_URDF), ("channel", CHANNEL_URDF), ("room", WORLD_URDF)):
        paths[name] = os.path.join(d, f"{name}.urdf")
        with open(paths[name], "w") as f:
            f.write(text)
    write_channel_stl(os.path.join(d, "uchannel.stl"))
    t0 = time.perf_counter()
    native = native_meshdist.available()
    build_s = time.perf_counter() - t0
    check(native, "the native mesh-distance library did not build (g++)")
    base = dict(checkCollisions=1, scaleCollisionHull=1.0, meshBaseDir="meshes",
                maxKinematicDistance=0)

    def verifier(robot, mode, world=None):
        tree = load_urdf(paths[robot])
        eng = DynamicsEngine(tree)
        wt = load_urdf(paths[world]) if world else None
        cm = CollisionModel(tree, eng, dict(base, collisionMode="capsule"), world_tree=wt)
        return MeshCollisionVerifier(tree, eng, dict(base, collisionMode=mode), cm,
                                     world_tree=wt, device="cuda")

    t0 = time.perf_counter()
    plates = verifier("plates", "convex")
    overlap = plates.verify(np.zeros((1, 2)))
    turned = plates.verify(np.array([[0.0, np.pi / 4]]))
    convex_cavity = verifier("channel", "convex").verify(np.array([[0.0, np.pi / 2]]))
    full = verifier("channel", "full")
    cavity = full.verify(np.array([[0.0, np.pi / 2]]))
    wall = full.verify(np.array([[0.0, 0.0]]))
    contained = verifier("channel", "full", world="room").verify(np.array([[0.0, np.pi / 2]]))
    res = dict(native_available=native, native_build_s=build_s, seconds=time.perf_counter() - t0,
               plates_overlap=overlap, plates_45deg=turned, channel_cavity_convex=convex_cavity,
               channel_cavity_full=cavity, channel_wall_full=wall, cage_containment_full=contained,
               native_pairs=sorted(full._native), card=gpu_name_power())
    emit("mesh_geometry_checks", **res)
    check(not overlap[0] and ("base_plate", "plate_b") in [p for p, _ in overlap[1]],
          f"convex tier: the overlapping plates were accepted: {overlap}")
    check(turned[0], f"convex tier: the 45-degree plates were rejected: {turned}")
    check(not convex_cavity[0], "convex tier: the hull must reject the bar in the cavity")
    check(bool(full._native) and cavity[0],
          f"full tier: the bar in the channel's cavity was rejected: {cavity}")
    check(not wall[0], f"full tier: the bar in the channel's wall was accepted: {wall}")
    check(not contained[0] and ("bar", "cage") in [p for p, _ in contained[1]],
          f"full tier: the bar contained in the world cage was accepted: {contained}")
    return res


def posture_first_generation(model, cfg: dict) -> np.ndarray:
    """The posture sets `optimize_postures` evaluates first: its rng draws
    the start mean, then the population around it."""
    from flobaroid_tpu_torch.excitation.posture import posture_bounds

    rng = np.random.default_rng(int(cfg.get("trajectoryOptSeed", 0)))
    n_post = max(int(cfg.get("numStaticPostures", 5)), 2)
    lo, hi = (np.tile(b, n_post) for b in posture_bounds(model))
    mean = lo + (hi - lo) * rng.random(len(lo))
    pop = max(int(cfg.get("globalOptSize", 12)), 8)
    X = np.clip(mean + 0.3 * (hi - lo) * rng.standard_normal((pop, len(lo))), lo, hi)
    X[0] = np.clip(mean, lo, hi)
    return X


def run_posture_leg(gram, tmp: str) -> dict:
    """`optimize_postures` on the arm with the defaults on the card (f32);
    its first generation against the port on the CPU in f64."""
    import torch

    from flobaroid_tpu_torch.excitation.posture import optimize_postures, posture_objective
    from flobaroid_tpu_torch.model import Model
    from flobaroid_tpu_torch.utils.config import load_config

    urdf = copy_urdf(ARM_URDF, os.path.join(tmp, "posture"), with_cache=False)
    opt = load_config(None, overrides=dict(floatingBase=0, verbose=0))
    start_shapes = Counter(gram.launch_shapes)
    model = Model(dict(opt), urdf, device="cuda")
    shapes = gram.launch_shapes - start_shapes
    check(dict(shapes) == {ARM_STRUCTURAL_SHAPE: 1},
          f"posture: launches {dict(shapes)} at Model init, not one at {ARM_STRUCTURAL_SHAPE}")
    t0 = time.perf_counter()
    postures = optimize_postures(model, dict(opt))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    X = posture_first_generation(model, opt)
    with torch.no_grad():
        card = posture_objective(model, opt)(
            torch.as_tensor(X, dtype=torch.float32, device="cuda")).double().cpu().numpy()
        result = float(posture_objective(model, opt)(torch.as_tensor(
            np.concatenate(postures)[None], dtype=torch.float32, device="cuda"))[0])
        cpu_model = Model(dict(opt, computeDtype="float64"), urdf, device="cpu")
        cpu = posture_objective(cpu_model, opt, dtype=torch.float64)(
            torch.as_tensor(X)).numpy()
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    res = dict(device="cuda", seconds=seconds, postures=len(postures),
               first_generation=len(X), first_generation_best=float(card.min()),
               result_objective=result, first_generation_rel_diff_vs_cpu_f64=rel,
               card=gpu_name_power())
    emit("posture_optimizer", **res)
    check(len(postures) == int(opt["numStaticPostures"])
          and all(np.all(np.isfinite(p)) for p in postures), "posture: non-finite postures")
    check(rel <= 1e-3, f"posture: first generation differs from the cpu f64 one by {rel}")
    check(np.isfinite(result) and result <= float(card.min()) + 1e-6 * abs(float(card.min())),
          f"posture: result {result} worse than the first generation's best {card.min()}")
    return res


def run_lagrangian_oracle() -> dict:
    """The Euler-Lagrange oracle on the card in f64 against the engine's
    RNEA: the arm (fixed base) and humanoid30 (floating base) at 4 states
    each, within tests/test_dynamics.py's tolerances."""
    import torch

    from flobaroid_tpu_torch.dynamics import lagrangian as lag
    from flobaroid_tpu_torch.dynamics import spatial as sp
    from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
    from flobaroid_tpu_torch.models.urdf import load_urdf

    res = {}
    for label, urdf, floating, tol in (("arm_fixed", ARM_URDF, False, 1e-8),
                                       ("humanoid30_floating", H30_URDF, True, 1e-7)):
        tree = load_urdf(urdf)
        eng = DynamicsEngine(tree)
        n = eng.num_dofs
        rng = np.random.default_rng(0)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64, device="cuda")

        pi = t(tree.std_params())
        errs = []
        t0 = time.perf_counter()
        for _ in range(4):
            q, dq, ddq = t(rng.uniform(-1.0, 1.0, n)), t(rng.normal(size=n)), t(rng.normal(size=n))
            if floating:
                rpy, drpy, ddrpy, dpb, ddpb = (t(a) for a in rng.normal(size=(5, 3)) * 0.4)
                want = lag.inverse_dynamics_floating(eng, pi, q, dq, ddq, rpy, drpy, ddrpy,
                                                     dpb, ddpb)
                w, wd = torch.func.jvp(lag.omega_world, (rpy, drpy), (drpy, ddrpy))
                base = (sp.rpy_to_rot(rpy).T[None], torch.cat([dpb, w])[None],
                        torch.cat([ddpb, wd])[None])
            else:
                want = lag.inverse_dynamics_fixed(eng, pi, q, dq, ddq)
                base = ()
            got = eng.inverse_dynamics_batch(pi, q[None], dq[None], ddq[None], *base)[0]
            errs.append(float((got - want).abs().max() / want.abs().max()))
        torch.cuda.synchronize()
        res[label] = dict(states=4, dofs=n, rows=n + (6 if floating else 0),
                          max_rel_err=max(errs), tol=tol, seconds=time.perf_counter() - t0)
    emit("lagrangian_oracle", device="cuda", dtype="float64", **res, card=gpu_name_power())
    for label, r in res.items():
        check(r["max_rel_err"] <= r["tol"],
              f"Lagrangian oracle ({label}): RNEA differs by {r['max_rel_err']} > {r['tol']}")
    return res


def run_model_analyses(gram, tmp: str) -> dict:
    """structural_identifiability and sensor_placement_study of humanoid30
    on the card (checked-in cache, WALK_OPTIONS), equal to the JAX
    package's figures."""
    import torch

    from flobaroid_tpu_torch.model import Model
    from flobaroid_tpu_torch.utils.config import load_config

    urdf = copy_urdf(H30_URDF, os.path.join(tmp, "analyses"), with_cache=True)
    before = gram.launches
    model = Model(load_config(None, overrides=WALK_OPTIONS), urdf, device="cuda")
    check(gram.launches == before, "model analyses: the checked-in structural cache was not used")
    t0 = time.perf_counter()
    ident = model.structural_identifiability()
    ident_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    study = model.sensor_placement_study(H30_SENSOR_SETS, n_samples=2000)
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    eqs = model.base_equations_str()
    res = dict(device="cuda", identifiability_s=ident_s, sensor_placement_s=study_s,
               identifiability={k: v for k, v in ident.items()
                                if k != "individually_identifiable_params"},
               sensor_placement=study, base_equations=len(eqs),
               description_lines=model.getDescriptionOfParameters().count("\n"),
               card=gpu_name_power())
    emit("model_analyses_humanoid30", **res)
    check(ident == H30_IDENTIFIABILITY_JAX,
          f"model analyses: structural identifiability {res['identifiability']} differs from "
          f"the JAX package's")
    check(study == H30_SENSOR_PLACEMENT_JAX,
          f"model analyses: sensor placement {study} differs from the JAX package's")
    check(len(eqs) == model.num_base_params, "model analyses: one base equation per base parameter")
    return res


def count_verifier_launches(verifier_leg: dict) -> int:
    """CUDA kernels of one `min_clearances` call over all the full-width
    leg's samples (torch.profiler; run last, after every wall is read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ver = verifier_leg["ver"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ver.min_clearances(verifier_leg["Q"], base_rot=verifier_leg["BR"],
                           base_pos=verifier_leg["BP"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    emit("mesh_verifier_launches", launches_per_verify=len(kernels),
         device_ms=device_ms, seconds=verifier_leg["seconds_cuda"],
         device_busy_share=device_ms / 1e3 / verifier_leg["seconds_cuda"], card=gpu_name_power())
    check(len(kernels) > 0, "mesh verifier: torch.profiler recorded no CUDA kernel")
    return len(kernels)


def essential_cuda_vs_cpu(gram) -> dict:
    """The arm's essential parameters (the deletion order decides the set)
    from 2000 states with noisy torques: the card's f32 Grams must give
    the essential set the CPU's give."""
    from flobaroid_tpu_torch.identification.identifier import Identification
    from flobaroid_tpu_torch.utils.config import load_config

    opt = load_config(None, overrides={**BENCH_OPTIONS, "randomSamples": 600,
                                       "simulateTorques": 0, "useEssentialParams": 1})
    out, samples = {}, None
    for device in ("cpu", "cuda"):
        idf = Identification(dict(opt), ARM_URDF, device=device)
        if samples is None:
            samples = build_samples(idf.model, 2000)
            tau = idf.model.simulate_dynamics(samples, np.arange(2000))
            samples["torques"] = tau + 0.05 * np.random.default_rng(7).standard_normal(tau.shape)
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        out[device] = idf
    c, g = out["cpu"], out["cuda"]
    res = dict(num_base_params=g.model.num_base_params,
               essential_cuda=g.baseEssentialIdx, essential_cpu=c.baseEssentialIdx,
               xBase_essential_rel_diff=float(
                   np.linalg.norm(g.xBase_essential - c.xBase_essential)
                   / np.linalg.norm(c.xBase_essential)),
               res_error_pct=[float(g.res_error), float(c.res_error)])
    emit("essential_cuda_vs_cpu", **res)
    check(g.baseEssentialIdx == c.baseEssentialIdx, "essential parameters: the card's set differs")
    check(0 < len(g.baseEssentialIdx) < g.model.num_base_params,
          f"essential parameters: {len(g.baseEssentialIdx)} of {g.model.num_base_params} kept")
    check(res["xBase_essential_rel_diff"] <= 1e-3,
          f"essential parameters: xBase_essential differs by {res['xBase_essential_rel_diff']}")
    return res


def compare_cuda_cpu(gram, label: str, tol: float, **kw) -> dict:
    """The same identify on the card and on the CPU: xBase within `tol`
    relative, the same SDP status."""
    rg = run_main_path(gram, device="cuda", label=f"{label}_cuda", **kw)
    rc = run_main_path(gram, device="cpu", label=f"{label}_cpu", **kw)
    xg, xc = np.asarray(rg["xBase"]), np.asarray(rc["xBase"])
    out = dict(xBase_rel_diff=float(np.linalg.norm(xg - xc) / np.linalg.norm(xc)),
               res_error_diff_pct_points=abs(rg["res_error_pct"] - rc["res_error_pct"]),
               sdp_status=[rg["sdp_status"], rc["sdp_status"]],
               num_base_params=rc["num_base_params"])
    emit(label, **out)
    check(out["xBase_rel_diff"] <= tol, f"{label}: xBase rel diff {out['xBase_rel_diff']}")
    check(rg["sdp_status"] == rc["sdp_status"], f"{label}: sdp status")
    return out


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
        # phase 3: the arm; each path's launches are counted from 0
        gram.launches = 0
        card_ranks = {}
        for label, n, warm in (("main_path_N2000", 2000, 5), ("main_path_N60000", 60000, 2)):
            urdf = copy_urdf(ARM_URDF, os.path.join(tmp, label), with_cache=False)
            card_ranks[label] = run_main_path(gram, urdf, n, warm, "cuda", label)["num_base_params"]
        arm_launches = gram.launches
        run_regressor_rate()
        # phase 4: the walking leg
        gram.launches = 0
        run_walking_leg(gram, tmp)
        walk_launches = gram.launches
        # phase 5: the CAD-study leg
        gram.launches = 0
        run_cad_leg(gram, tmp)
        cad_launches = gram.launches
        # phases 6-8: the trajectory (with the exact-mesh verification),
        # suspended-objective and simulator legs
        gram.launches = 0
        traj_runs = run_trajectory_leg(gram, tmp)
        traj_launches = gram.launches
        extra_paths = {}
        if not any(r["backoff_ran"] for r in traj_runs.values()):
            # no seed needed the back-off: drive it with the stand-in geometry
            gram.launches = 0
            run_mesh_backoff_leg(gram, tmp)
            extra_paths["mesh_backoff"] = gram.launches
        gram.launches = 0
        _, sus_obj, sus_X = run_suspended_leg(gram, tmp)
        suspended_launches = gram.launches
        verifier_leg = run_mesh_verifier_leg(sus_obj, sus_X)
        del sus_obj
        run_mesh_geometry_checks(tmp)
        gram.launches = 0
        run_simulator_leg(gram, tmp)
        sim_launches = gram.launches
        # the static-posture optimizer, the Lagrangian oracle, the analyses
        gram.launches = 0
        run_posture_leg(gram, tmp)
        extra_paths["posture"] = gram.launches
        run_lagrangian_oracle()
        before = gram.launches
        run_model_analyses(gram, tmp)
        check(gram.launches == before, "model analyses launched the Gram kernel")

        # phase 9: the port on the card vs on the CPU, both on the
        # checked-in caches (the arm's randomSamples=600 hits it), so both
        # use one structural projection
        arm = compare_cuda_cpu(gram, "cuda_vs_cpu", 1e-4, urdf=ARM_URDF, n=2000, warm=0,
                               opt_overrides=dict(randomSamples=600), cache_miss=False)
        check(arm["res_error_diff_pct_points"] <= 1e-3,
              f"cuda vs cpu res_error diff {arm['res_error_diff_pct_points']}")
        for label, rank in card_ranks.items():
            check(rank == arm["num_base_params"],
                  f"{label}: structural rank {rank} on the card, {arm['num_base_params']} on the CPU")
        # humanoid30 walking at 1200 samples, generated once on the card
        walk_samples = {}

        def card_walk_samples(model, n):
            if "s" not in walk_samples:
                walk_samples["s"] = walking_samples(model, n)
            return walk_samples["s"]

        compare_cuda_cpu(gram, "walking_cuda_vs_cpu", 1e-3,
                         urdf=copy_urdf(H30_URDF, os.path.join(tmp, "walk_cmp"), with_cache=True),
                         n=1200, warm=0, cache_miss=False, options=WALK_OPTIONS,
                         make_samples=card_walk_samples)
        essential_cuda_vs_cpu(gram)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "flobaroid_tpu" or m.startswith("flobaroid_tpu.") for m in sys.modules),
          "the JAX package flobaroid_tpu was imported")

    phase_device_times(gram, kern)
    count_verifier_launches(verifier_leg)
    # headline: the shape with the most kernel time per pass, the walking
    # leg's 4096-sample chunk; by_shape: every shape a path runs.
    # ms / plain_ms: CUDA-event time of one call (host included) of the
    # kernel / of the plain version; device_ms / library_ms: torch.profiler
    # device time of the kernel / of the library call. gram_plain is the
    # einsum, so the plain version and the library call are one call.
    keys = ("max_abs_err", "ms", "plain_ms", "device_ms", "library_ms", "bound_ms", "bound_by")
    main_shape = kern["walking_chunk_B36_N4096_C432"]
    by_path = {"arm": arm_launches, "walking": walk_launches, "cad_study": cad_launches,
               "trajectory": traj_launches, "suspended_objective": suspended_launches,
               "simulate_and_identify": sim_launches, **extra_paths}
    for path, n in by_path.items():
        check(n > 0, f"the {path} path launched the Gram kernel no time")
    print(json.dumps({"kernels": [{
        "name": "gram_batched",
        "route": "cuda",
        "source": "flobaroid_tpu_torch/csrc/gram.cu",
        "replaces": "flobaroid_tpu/ops/gram.py:48",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "shape": "4096x36x432",
        **{k: main_shape[k] for k in keys},
        "by_shape": {name: {k: r[k] for k in keys} for name, r in kern.items()
                     if r["on_main_path"]},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
