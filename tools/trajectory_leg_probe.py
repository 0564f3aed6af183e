"""Probes of chip_smoke.py's trajectory leg (the 7-DOF arm, bench.py's
fourth-leg budget, seed 0) that the smoke test itself does not make.

    python tools/trajectory_leg_probe.py run <cpu|cuda> [float32|float64] [threads] [seeds] [jitters]
    python tools/trajectory_leg_probe.py profile
    python tools/trajectory_leg_probe.py shard <cpu|cuda>

`run` drives the whole leg on one device with the objective in one dtype
(on a CPU with the given thread count), once per `trajectoryOptSeed` of
the comma-separated `seeds` (default 0) and, with `jitters` > 1, again
with the local stage started a rounding-sized step (1e-6 of the box,
numpy seed 1000 + j) off the global search's winner, and prints one line per batched
evaluation (best f, feasible count, the first 8 values and violations),
then the result and bench.py's `dopt_of` of it: the spread of the
optimization under rounding alone is read from several such runs.
`profile` (needs a card) holds the card's f32 augmented-Lagrangian
values and gradients of 8 first-generation candidates against the CPU in
f32 and f64, times one AL step and its forward pass, and prints a
torch.profiler table of one step (kernel launches, device time).
`shard` runs chip_smoke.py's `sharded_candidates` augmented-Lagrangian
stage (8 restarts x 40 Adam steps of the first generation) in f32 and
f64, from candidates 0-7 (candidate 0 is the CEM mean, on the kink at
q0 = 0) and from candidates 1-8, as one batch of 8 (twice), over
`shardCandidates: 2`, and as two separate unsharded batches of 4, and
prints the largest difference in f and g (relative to their largest
magnitude) of each pair of runs: whether two runs differ because they
were sharded or because their batches differ in size.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from flobaroid_tpu_torch.collision import CollisionModel  # noqa: E402
from flobaroid_tpu_torch.excitation.objective import TrajectoryObjective  # noqa: E402
from flobaroid_tpu_torch.excitation.optimizer import (  # noqa: E402
    build_bounds, initial_candidate, optimize_trajectory)
from flobaroid_tpu_torch.excitation.trajectory import FourierSpec  # noqa: E402
from flobaroid_tpu_torch.model import Model  # noqa: E402


def build_kernel():
    from flobaroid_tpu_torch.ops import _build, gram

    _build.build_library("gram")
    gram._lib()


def run(device: str, dtype: torch.dtype, threads: int, seeds: list[int], jitters: int = 1) -> None:
    torch.set_num_threads(threads)
    if device == "cuda":
        build_kernel()
    urdf = cs.copy_urdf(cs.ARM_URDF, tempfile.mkdtemp(prefix="flobaroid_probe_"), with_cache=False)

    class Traced(TrajectoryObjective):
        def __init__(self, *a, **k):
            super().__init__(*a, **dict(k, dtype=dtype))

        def evaluate_batch(self, X):
            f, g, n = super().evaluate_batch(X)
            if len(f) > 1:
                viol = np.max(np.maximum(g, 0), axis=1)
                print(json.dumps(dict(
                    n=len(f), fmin=float(f.min()), feasible=int(np.all(g <= 0.01, axis=1).sum()),
                    f=[round(float(v), 4) for v in f[:8]],
                    violation=[round(float(v), 4) for v in viol[:8]])), flush=True)
            return f, g, n

    import flobaroid_tpu_torch.excitation.optimizer as optimizer_module

    optimizer_module.TrajectoryObjective = Traced
    refine = optimizer_module.local_refine_batch
    jitter = 0

    def jittered_refine(obj, config, x0, rng=None, should_stop=None):
        if jitter:
            lo, hi = optimizer_module.build_bounds(obj.spec, config)
            x0 = x0 + 1e-6 * (hi - lo) * np.random.default_rng(1000 + jitter).standard_normal(len(x0))
        return refine(obj, config, x0, rng=rng, should_stop=should_stop)

    optimizer_module.local_refine_batch = jittered_refine
    for seed, jitter in ((s, j) for s in seeds for j in range(jitters)):
        opt, cfg = cs.trajectory_leg_config(seed)
        model = Model(opt, urdf, device=device)
        t0 = time.time()
        x, spec, obj, info = optimize_trajectory(model, cfg)
        f, c = cs.trajectory_dopt(model, opt, spec, x)
        print(json.dumps(dict(
            package="flobaroid_tpu_torch", seed=seed, jitter=jitter, device=device, dtype=str(dtype),
            threads=threads, card=cs.gpu_name_power() if device == "cuda" else None,
            seconds=time.time() - t0, neg_logdet=f, base_cond=c, pulse=float(x[0]), **info,
            x=[float(v) for v in x])),
            flush=True)


def profile() -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    build_kernel()
    opt, cfg = cs.trajectory_leg_config()
    urdf = cs.copy_urdf(cs.ARM_URDF, tempfile.mkdtemp(prefix="flobaroid_probe_"), with_cache=False)
    objs = {}
    for name, dev, dt in (("cuda_f32", "cuda", torch.float32), ("cpu_f32", "cpu", torch.float32),
                          ("cpu_f64", "cpu", torch.float64)):
        m = Model(dict(opt, computeDtype=str(dt).replace("torch.", "")), urdf, device=dev)
        lims = m.limits
        spec = FourierSpec(nf=(int(opt["trajectoryDefaultNf"]),) * m.num_dofs, limits=tuple(
            (float(lims[j]["lower"]), float(lims[j]["upper"])) for j in m.jointNames))
        cm = CollisionModel(m.tree, m.engine, cfg)
        objs[name] = TrajectoryObjective(
            m, cfg, spec, extra_constraints_fn=cm.trajectory_constraint_fn(step=3, n_transition=10),
            n_extra_constraints=cm.num_pairs, dtype=dt)
    X = cs.first_generation(spec, cfg)
    x0 = initial_candidate(spec, cfg, np.random.default_rng(0))
    for o in objs.values():
        o.calibrate_scale(x0)
    ref_f, ref_g, _ = objs["cpu_f64"].evaluate_batch(X)
    rng = np.random.default_rng(1)
    LAM, RHO = np.abs(rng.standard_normal((8, ref_g.shape[1]))), np.full(8, 10.0)
    ref_v, ref_grad = objs["cpu_f64"].al_value_and_grad(X[:8], LAM, RHO)
    for k in ("cuda_f32", "cpu_f32"):
        f, g, _ = objs[k].evaluate_batch(X)
        v, grad = objs[k].al_value_and_grad(X[:8], LAM, RHO)
        print(json.dumps(dict(
            chain=k, f_rel=float(np.abs(f - ref_f).max() / np.abs(ref_f).max()),
            g_abs=float(np.abs(g - ref_g).max()),
            al_value_rel=float(np.abs(v - ref_v).max() / np.abs(ref_v).max()),
            al_grad_rel=(np.linalg.norm(grad - ref_grad, axis=1)
                         / np.linalg.norm(ref_grad, axis=1)).tolist())))
    o = objs["cuda_f32"]
    lam, rho, shift, Xt = o._t(LAM), o._t(RHO), o._shift_t, o._x(X[:8])

    def step():
        return o._value_and_grad(lambda X_: o._al_value(X_, lam, rho, shift), Xt)

    def forward():
        with torch.no_grad():
            return o._al_value(Xt, lam, rho, shift)

    for name, fn in (("al_step_ms", step), ("al_forward_ms", forward)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        print(json.dumps({name: (time.perf_counter() - t0) / 5 * 1e3, "card": cs.gpu_name_power()}))
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12,
                                    max_name_column_width=60))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=6,
                                    max_name_column_width=60))


def shard(device: str) -> None:
    if device == "cuda":
        build_kernel()
    opt, cfg = cs.trajectory_leg_config()
    urdf = cs.copy_urdf(cs.ARM_URDF, tempfile.mkdtemp(prefix="flobaroid_probe_"), with_cache=False)
    m = Model(opt, urdf, device=device)
    lims = m.limits
    spec = FourierSpec(nf=(int(opt["trajectoryDefaultNf"]),) * m.num_dofs, limits=tuple(
        (float(lims[j]["lower"]), float(lims[j]["upper"])) for j in m.jointNames))
    cm = CollisionModel(m.tree, m.engine, cfg)
    X = cs.first_generation(spec, cfg)
    x0 = initial_candidate(spec, cfg, np.random.default_rng(0))
    lo, hi = build_bounds(spec, cfg)
    for dt in (torch.float32, torch.float64):
        obj = TrajectoryObjective(
            m, dict(cfg), spec, dtype=dt, n_extra_constraints=cm.num_pairs,
            extra_constraints_fn=cm.trajectory_constraint_fn(
                step=int(cfg.get("collisionCheckStep", 3)), n_transition=10))
        obj.calibrate_scale(x0)
        for first in (0, 1):
            Xs = X[first:first + 8]
            LAM, RHO = np.zeros((8, obj.evaluate(x0)[1].shape[0])), np.full(8, 10.0)

            def stage(rows, shards):
                obj.config["shardCandidates"] = shards
                out = obj.al_refine_batch(Xs[rows], lo, hi, LAM[rows], RHO[rows],
                                          lr=0.01, n_steps=40)
                obj.config["shardCandidates"] = 0
                return out

            runs = dict(batch8=stage(slice(0, 8), 0), batch8_again=stage(slice(0, 8), 0),
                        sharded2x4=stage(slice(0, 8), 2),
                        split2x4=np.concatenate([stage(slice(0, 4), 0), stage(slice(4, 8), 0)]))
            ev = {k: obj.evaluate_batch(v) for k, v in runs.items()}

            def diff(a, b):
                (fa, ga, _), (fb, gb, _) = ev[a], ev[b]
                return dict(f=float(np.abs(fa - fb).max() / np.abs(fb).max()),
                            g=float(np.abs(ga - gb).max() / np.abs(gb).max()))

            print(json.dumps(dict(
                device=device, dtype=str(dt), candidates=f"{first}-{first + 7}",
                card=cs.gpu_name_power() if device == "cuda" else None,
                batch8_again_vs_batch8=diff("batch8_again", "batch8"),
                sharded2x4_vs_batch8=diff("sharded2x4", "batch8"),
                split2x4_vs_batch8=diff("split2x4", "batch8"),
                sharded2x4_vs_split2x4=diff("sharded2x4", "split2x4"))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        run(sys.argv[2], getattr(torch, sys.argv[3] if len(sys.argv) > 3 else "float32"),
            int(sys.argv[4]) if len(sys.argv) > 4 else 4,
            [int(v) for v in (sys.argv[5] if len(sys.argv) > 5 else "0").split(",")],
            int(sys.argv[6]) if len(sys.argv) > 6 else 1)
    elif sys.argv[1:2] == ["profile"]:
        profile()
    elif sys.argv[1:2] == ["shard"] and len(sys.argv) > 2:
        shard(sys.argv[2])
    else:
        sys.exit(__doc__)
