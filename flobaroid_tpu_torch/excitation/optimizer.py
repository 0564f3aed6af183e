"""Trajectory optimization: on-device global search + gradient refinement.

Counterpart of flobaroid_tpu/excitation/optimizer.py (reference
excitation/optimizer.py + trajectoryOptimizer.py): the Optuna
TPE/NSGA-II worker-process swarm becomes a cross-entropy / elite
evolution search (with restarts) evaluating whole candidate populations
in one batched device call, and the IPOPT local stage becomes an
augmented-Lagrangian method over the exact autograd gradient of the
objective chain: per-stage multiplier updates give active constraints
exact multipliers, so feasibility does not rest on penalty weights going
to infinity (no finite differences, no multiprocessing gradient pool).

Feasibility handling mirrors the reference: infeasible candidates are
repaired by scaling their Fourier amplitudes down
(globalOptAmplitudeRepair, trajectoryOptimizer.py:721-764), the best
feasible solution is tracked across both stages, and Ctrl-C returns
best-so-far (reference trajectoryOptimizer.py:860-882).

All random draws are numpy's (`np.random.default_rng`), in the JAX
module's order, so both packages draw the same candidates from one seed.
With `collisionMode` other than "capsule" the winner is verified against
exact geometry (`collision_mesh.MeshCollisionVerifier`) and, where that
fails, repaired by tightening the violated capsule constraints
(`_mesh_backoff_refine`). With `shardCandidates: n > 1` the global
search and the local stage run their batches over n candidate shards
(`TrajectoryObjective.evaluate_batch`, `al_refine_batch`).
"""

from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import torch

from .objective import TrajectoryObjective
from .trajectory import FourierSpec


class Checkpoint:
    """Mid-optimization checkpoint/resume (beyond the reference, which
    only checkpoints at stage boundaries via npz files — SURVEY §5 'no
    mid-optimization resume'). One npz holds the phase, loop counters,
    search state and best-so-far; saves are atomic (tmp + replace), and
    a checkpoint from a different phase or parameter dimension is
    ignored. Enabled by `trajectoryCheckpointFile`."""

    def __init__(self, config: dict, dim: int):
        self.path = str(config.get("trajectoryCheckpointFile", "") or "")
        self.dim = dim

    def load(self, phase: str):
        if not self.path or not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as f:
                if str(f["phase"]) != phase or int(f["dim"]) != self.dim:
                    return None
                return {k: f[k] for k in f.files}
        except (OSError, ValueError, KeyError):
            return None

    def save(self, phase: str, **arrays) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, phase=phase, dim=self.dim, **arrays)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        if self.path and os.path.exists(self.path):
            os.remove(self.path)

    @staticmethod
    def pack_rng(rng) -> str:
        return json.dumps(rng.bit_generator.state)

    @staticmethod
    def restore_rng(rng, packed) -> None:
        rng.bit_generator.state = json.loads(str(packed))


class InterruptGuard:
    """SIGINT -> set a flag instead of raising; the optimization loops
    poll it and return best-so-far (reference
    trajectoryOptimizer.py:860-882, optimizer.py:1050-1060)."""

    def __init__(self):
        self.hit = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            print("interrupt: returning best solution found so far")
            self.hit = True

        try:
            self._prev = signal.signal(signal.SIGINT, handler)
        except ValueError:  # not in the main thread
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
        return False

    def __call__(self):
        return self.hit


def build_bounds(spec: FourierSpec, config: dict, limits_rad=None):
    """Variable bounds [wf, q0*, a*, b*] (reference
    trajectoryOptimizer.py:803-846)."""
    n = spec.num_dofs
    lo = [float(config.get("trajectoryPulseMin", 0.3))]
    hi = [float(config.get("trajectoryPulseMax", 1.0))]
    center_freedom = np.deg2rad(float(config.get("trajectoryCenterFreedom", 25.0)))
    lo += [-center_freedom] * n
    hi += [center_freedom] * n
    cmin = float(config.get("trajectoryCoeffMin", -0.5))
    cmax = float(config.get("trajectoryCoeffMax", 0.5))
    tot = sum(spec.nf)
    lo += [cmin] * (2 * tot)
    hi += [cmax] * (2 * tot)
    return np.asarray(lo), np.asarray(hi)


def initial_candidate(spec: FourierSpec, config: dict, rng) -> np.ndarray:
    """1/k harmonic taper init (reference trajectoryOptimizer.py:766-801)."""
    wf = float(config.get("trajectoryPulseInit", 0.5))
    coeff = float(config.get("trajectoryCoeffInit", 0.4))
    q0 = np.zeros(spec.num_dofs)
    a, b = [], []
    for nf in spec.nf:
        k = np.arange(1, nf + 1)
        a.append(coeff / k * rng.uniform(0.7, 1.0, nf) * rng.choice([-1, 1], nf))
        b.append(coeff / k * rng.uniform(0.7, 1.0, nf) * rng.choice([-1, 1], nf))
    return spec.join(wf, q0, a, b)


def amplitude_repair(obj: TrajectoryObjective, x, max_steps=12, factor=0.8):
    """Scale Fourier amplitudes down until feasible
    (reference trajectoryOptimizer.py:721-764)."""
    spec = obj.spec
    n = spec.num_dofs
    x = np.array(x, dtype=float)
    for _ in range(max_steps):
        f, g, _ = obj.evaluate(x)
        if obj.feasible(g):
            return x, True
        x[1 + n :] *= factor
    f, g, _ = obj.evaluate(x)
    return x, obj.feasible(g)


def global_search(
    obj: TrajectoryObjective,
    config: dict,
    seeds: list[np.ndarray] | None = None,
    rng=None,
    penalty: float = 100.0,
    should_stop=None,
):
    """Cross-entropy / elite evolution over the bounded parameter box
    with independent restarts, one batched evaluation per generation
    (replaces the Optuna TPE worker swarm; populations are nearly free
    per generation as a batch, so the default budget is deliberately
    much larger than the reference's trial counts)."""
    rng = rng or np.random.default_rng(0)
    spec = obj.spec
    lo, hi = build_bounds(spec, config)
    pop = max(int(config.get("globalOptSize", 256)), 8)
    iters = max(int(config.get("globalOptIterations", 10)), 1)
    restarts = max(int(config.get("globalOptRestarts", 2)), 1)
    dim = spec.dim

    best_x, best_f, best_feas = None, np.inf, False

    def penalized(fv, gv):
        viol = np.maximum(gv, 0.0)
        return fv + penalty * (viol**2).sum(axis=-1) + 0.1 * penalty * viol.sum(axis=-1)

    ckpt = Checkpoint(config, dim)
    resume = ckpt.load("global")
    r0 = it0 = 0
    mean = sigma = None
    # seeds ride in the checkpoint (VERDICT r2 #8): a resume must
    # re-inject them at (restart 0, generation 0) even when the caller
    # does not pass them again — the save happens BEFORE the seeded
    # generation evaluates, so relying on rng replay + caller args alone
    # silently loses seeds on that resume path
    seeds_arr = (
        np.stack([np.asarray(s, float) for s in seeds])
        if seeds else np.zeros((0, dim))
    )
    if resume is not None:
        r0 = int(resume["r"])
        it0 = int(resume["it"])
        mean = np.asarray(resume["mean"], float)
        sigma = np.asarray(resume["sigma"], float)
        best_x = np.asarray(resume["best_x"], float)
        best_f = float(resume["best_f"])
        best_feas = bool(resume["best_feas"])
        Checkpoint.restore_rng(rng, resume["rng_state"])
        if "seeds" in resume and np.asarray(resume["seeds"]).shape[0] > 0:
            seeds_arr = np.asarray(resume["seeds"], float)
            seeds = [s for s in seeds_arr]
        print(f"resuming global search from checkpoint "
              f"(restart {r0}, generation {it0})")

    for r in range(r0, restarts):
        if mean is None:
            mean = np.clip(initial_candidate(spec, config, rng), lo, hi)
            sigma = 0.3 * (hi - lo)
        if best_x is None:
            best_x = mean.copy()
        for it in range(it0, iters):
            if should_stop is not None and should_stop():
                return best_x, best_f, best_feas
            ckpt.save("global", r=r, it=it, mean=mean, sigma=sigma,
                      best_x=best_x, best_f=best_f, best_feas=best_feas,
                      seeds=seeds_arr,
                      rng_state=Checkpoint.pack_rng(rng))
            X = mean[None, :] + sigma[None, :] * rng.standard_normal((pop, dim))
            X = np.clip(X, lo, hi)
            X[0] = mean  # elitism
            if it == 0 and seeds and r == 0:
                for k, s in enumerate(seeds[: pop - 1]):
                    X[k + 1] = np.clip(s, lo, hi)
            f, g, _ = obj.evaluate_batch(X)
            feas = np.all(g <= 0, axis=1)
            score = penalized(f, g)
            order = np.argsort(score)
            # track best (feasible beats infeasible)
            for i in order:
                if feas[i] and (not best_feas or f[i] < best_f):
                    best_x, best_f, best_feas = X[i].copy(), float(f[i]), True
                    break
            if not best_feas and float(score[order[0]]) < best_f:
                best_x, best_f = X[order[0]].copy(), float(score[order[0]])
            n_elite = max(pop // 4, 2)
            elite = X[order[:n_elite]]
            mean = elite.mean(axis=0)
            sigma = elite.std(axis=0) * 1.2 + 1e-4 * (hi - lo)
        mean = None  # next restart draws a fresh mean
        it0 = 0
    if not best_feas and config.get("globalOptAmplitudeRepair", 1):
        best_x, best_feas = amplitude_repair(obj, best_x)
        if best_feas:
            best_f = obj.evaluate(best_x)[0]
    return best_x, best_f, best_feas


def local_refine(
    obj: TrajectoryObjective,
    config: dict,
    x0: np.ndarray,
    should_stop=None,
):
    """Augmented-Lagrangian refinement on the exact gradient (replaces
    IPOPT + FD/multiprocessing gradients, reference
    excitation/optimizer.py:1138-1250). Per stage: one on-device
    Adam run on L(x; lam, rho), then the first-order multiplier update
    lam <- max(0, lam + rho g(x)); rho grows only while infeasibility
    stalls. Active constraints converge to exact multipliers, so the
    final iterate is feasible without amplitude backoff in the regular
    case (the repair stays as a last resort)."""
    spec = obj.spec
    lo, hi = build_bounds(spec, config)
    iters = max(int(config.get("localOptIterations", 10)), 1) * 40
    stages = max(int(config.get("localOptStages", 6)), 1)
    x = np.clip(np.array(x0, dtype=float), lo, hi)
    best_x, best_f, best_feas = x.copy(), np.inf, False

    f0, g0, _ = obj.evaluate(x)
    if obj.feasible(g0):
        best_x, best_f, best_feas = x.copy(), f0, True

    lam = np.zeros_like(g0)
    rho = 10.0
    prev_viol = float(np.max(np.maximum(g0, 0.0)))
    ckpt = Checkpoint(config, spec.dim)
    s0 = 0
    resume = ckpt.load("local")
    if resume is not None:
        s0 = int(resume["s"])
        x = np.asarray(resume["x"], float)
        lam = np.asarray(resume["lam"], float)
        rho = float(resume["rho"])
        prev_viol = float(resume["prev_viol"])
        best_x = np.asarray(resume["best_x"], float)
        best_f = float(resume["best_f"])
        best_feas = bool(resume["best_feas"])
        print(f"resuming local refinement from checkpoint (stage {s0})")
    for _s in range(s0, stages):
        if should_stop is not None and should_stop():
            break
        ckpt.save("local", s=_s, x=x, lam=lam, rho=rho, prev_viol=prev_viol,
                  best_x=best_x, best_f=best_f, best_feas=best_feas)
        x, _ = obj.al_refine(x, lo, hi, lam, rho, lr=0.01, n_steps=iters)
        x = np.clip(x, lo, hi)
        f, g, _ = obj.evaluate(x)
        viol = float(np.max(np.maximum(g, 0.0)))
        if obj.feasible(g) and f < best_f:
            best_x, best_f, best_feas = x.copy(), float(f), True
        lam = np.maximum(0.0, lam + rho * np.asarray(g))
        if viol > 0.25 * max(prev_viol, 1e-12):
            rho = min(rho * 4.0, 1e6)
        prev_viol = viol
    if not best_feas:
        xr, ok = amplitude_repair(obj, x)
        if ok:
            f, g, _ = obj.evaluate(xr)
            best_x, best_f, best_feas = xr, float(f), True
    return best_x, best_f, best_feas


def local_refine_batch(obj, config, x0, rng=None, should_stop=None):
    """K independent augmented-Lagrangian restarts refined as ONE
    batch (localOptRestarts > 1): restart 0 starts at the global-search
    winner, the others at box-scaled jitters of it, and every AL stage
    advances ALL restarts together (obj.al_refine_batch). The reference
    runs IPOPT restarts as sequential host processes (reference
    excitation/optimizer.py:1138-1250); here the restart axis is just
    one more batch axis. Per-restart multipliers/penalties evolve
    independently on host.
    Returns (best_x, best_f, best_feas) over all restarts."""
    K = max(int(config.get("localOptRestarts", 1)), 1)
    if K == 1:
        return local_refine(obj, config, x0, should_stop=should_stop)
    rng = rng or np.random.default_rng(
        int(config.get("trajectoryOptSeed", 0)) + 1
    )
    spec = obj.spec
    nd = spec.num_dofs
    lo, hi = build_bounds(spec, config)
    iters = max(int(config.get("localOptIterations", 10)), 1) * 40
    stages = max(int(config.get("localOptStages", 6)), 1)
    X = np.tile(np.clip(np.asarray(x0, float), lo, hi), (K, 1))
    # restart diversity: an AMPLITUDE LADDER, not just jitter. When the
    # global winner is infeasible-hot (over torque/velocity limits), a
    # uniform amplitude backoff can overshoot into the min-velocity /
    # min-torque-utilization floor — the feasible set is a band, and
    # gradient descent from one knife-edge start reaches it only by
    # luck (1e-4-level arithmetic differences decide it).
    # Restart k scales the Fourier coefficients by 0.85^(k//2), odd k
    # adds a small box jitter; restart 0 is the unmodified start.
    for k in range(1, K):
        X[k, 1 + nd:] *= 0.85 ** (k // 2)
        if k % 2:
            X[k] += 0.03 * (hi - lo) * rng.standard_normal(spec.dim)
    X = np.clip(X, lo, hi)

    F, G, _ = obj.evaluate_batch(X)
    best_X = X.copy()
    best_F = np.full(K, np.inf)
    best_feas = np.zeros(K, dtype=bool)
    for k in range(K):
        if obj.feasible(G[k]):
            best_F[k], best_feas[k] = float(F[k]), True
    LAM = np.zeros_like(G)
    RHO = np.full(K, 10.0)
    prev_viol = np.max(np.maximum(G, 0.0), axis=1)
    for _s in range(stages):
        if should_stop is not None and should_stop():
            break
        X = obj.al_refine_batch(X, lo, hi, LAM, RHO, lr=0.01, n_steps=iters)
        X = np.clip(X, lo, hi)
        F, G, _ = obj.evaluate_batch(X)
        viol = np.max(np.maximum(G, 0.0), axis=1)
        for k in range(K):
            if obj.feasible(G[k]) and F[k] < best_F[k]:
                best_X[k], best_F[k], best_feas[k] = X[k].copy(), float(F[k]), True
        LAM = np.maximum(0.0, LAM + RHO[:, None] * np.asarray(G))
        RHO = np.where(
            viol > 0.25 * np.maximum(prev_viol, 1e-12),
            np.minimum(RHO * 4.0, 1e6), RHO,
        )
        prev_viol = viol
    if np.any(best_feas):
        order = np.argsort(np.where(best_feas, best_F, np.inf))
        k = int(order[0])
        return best_X[k], float(best_F[k]), True
    # no restart reached feasibility: amplitude-repair the least
    # violating iterate (same last resort as the single-restart path)
    k = int(np.argmin(prev_viol))
    xr, ok = amplitude_repair(obj, X[k])
    if ok:
        f, g, _ = obj.evaluate(xr)
        return xr, float(f), True
    return X[k], float(F[k]), False


def _mesh_backoff_refine(config, spec, obj, cm, ver, x, bad, guard, info, n_trans, step_v):
    """Constraint-inflation recovery after a mesh-verification failure
    (the reference re-optimizes through its normal loop,
    optimizer.py:1099-1132). Instead of shrinking amplitudes 0.85^k, the
    violating pairs' constraints are tightened by the MEASURED
    capsule-vs-mesh gap (+ `meshBackoffSlack`) through the objective's
    extra-shift, and one augmented-Lagrangian refinement re-runs, for up
    to three rounds; amplitude shrinking remains the last resort. Reports
    the D-optimality before and after on the unshifted constraints in
    `info`. Returns (x, ok, bad)."""
    f_before = float(obj.evaluate(x)[0])
    d_before = obj.dopt(x)
    info["f_before_backoff"] = f_before
    info["dopt_before_backoff"] = d_before
    slack = float(config.get("meshBackoffSlack", 0.002))
    n = spec.num_dofs
    print(f"mesh verification: {len(bad)} pair(s) violate exact geometry "
          f"(worst {min(d for _, d in bad):.4f} m) — tightening the "
          f"violated collision constraints by the measured gap and "
          f"re-refining")

    cap_fn = cm.trajectory_constraint_fn(step=step_v, n_transition=n_trans)
    shift = np.asarray(obj._extra_shift, dtype=np.float64).copy()
    ok = False
    for _round in range(3):
        if guard():
            break
        Q, BR, BP = obj.kinematics(x)
        args = (Q,) if BR is None else (Q, BR, BP)
        with torch.no_grad():
            g_cap = cap_fn(*(obj._t(a) for a in args)).double().cpu().numpy()
        for pair, d_mesh in bad:
            try:
                i = cm.pair_names.index(tuple(pair))
            except ValueError:
                continue
            cap_clear = -(float(g_cap[i]) + shift[i])
            gap = cap_clear - float(d_mesh)
            shift[i] += max(gap, 0.0) + slack
        obj.set_extra_shift(shift)
        cfg_r = dict(config)
        cfg_r["trajectoryCheckpointFile"] = ""  # no resume interference
        # the recovery owns its refinement budget: a caller running a
        # quick low-budget optimization still deserves a real attempt at
        # preserving D-optimality here (the whole point vs 0.85^k)
        cfg_r["localOptStages"] = max(4, int(config.get("localOptStages", 6)))
        cfg_r["localOptIterations"] = max(3, int(config.get("localOptIterations", 10)))
        x_new, _f, _feas = local_refine(obj, cfg_r, x, should_stop=guard)
        Q, BR, BP = obj.kinematics(x_new)
        ok, bad = ver.verify(Q, base_rot=BR, base_pos=BP, step=step_v)
        x = np.asarray(x_new, dtype=float)
        if ok:
            break
    if not ok:
        # last resort: global amplitude shrink
        for _attempt in range(10):
            Q, BR, BP = obj.kinematics(x)
            ok, bad = ver.verify(Q, base_rot=BR, base_pos=BP, step=step_v)
            if ok:
                break
            x = np.array(x, dtype=float)
            x[1 + n:] *= 0.85
    # report on the ORIGINAL (unshifted) constraints for comparability
    obj.set_extra_shift(np.zeros_like(shift))
    f_after = float(obj.evaluate(x)[0])
    d_after = obj.dopt(x)
    info["f_after_backoff"] = f_after
    info["dopt_after_backoff"] = d_after
    if d_before != 0:
        info["dopt_backoff_loss_pct"] = round(
            100.0 * (d_after - d_before) / abs(d_before), 3
        )
    return x, ok, bad


def optimize_trajectory(model, config, yty_prior=None, seeds=None, rng=None):
    """Full global+local optimization on the model's device. Returns
    (x, spec, obj, info).

    Mirrors TrajectoryOptimizer.optimizeTrajectory
    (trajectoryOptimizer.py:860) / runOptimizer (optimizer.py:1138)."""
    check_collisions = bool(config.get("checkCollisions", 1))
    rng = rng or np.random.default_rng(int(config.get("trajectoryOptSeed", 0)))
    nf_cfg = config.get("trajectoryNf", {}) or {}
    default_nf = int(config.get("trajectoryDefaultNf", 4))
    nf = tuple(int(nf_cfg.get(j, default_nf)) for j in model.jointNames)
    lims = model.limits
    limits = tuple(
        (float(lims[j]["lower"]), float(lims[j]["upper"])) for j in model.jointNames
    )
    # reference key trajectoryBounded (trajectoryOptimizer.py:70):
    # bounded tanh mode guarantees position limits by construction.
    # This repo defaults it ON (the reference defaults to the classic
    # pulsed series) — classic mode still enforces position limits as
    # hard constraints in the objective, so an explicit
    # trajectoryBounded: 0 keeps reference behavior
    bounded = bool(config.get("trajectoryBounded", 1))
    spec = FourierSpec(nf=nf, limits=limits if bounded else None)

    # collision constraints (one per pair, reference
    # trajectoryOptimizer.py:340-437): periodic part at swung base
    # poses + min-jerk transition ramps at representative poses
    extra_fn = None
    cm = None
    world_tree = None
    n_trans = 0
    if check_collisions:
        from ..collision import CollisionModel
        from ..models.urdf import load_urdf

        world_tree = (
            load_urdf(config["worldUrdf"]) if config.get("worldUrdf") else None
        )
        cm = CollisionModel(model.tree, model.engine, config, world_tree=world_tree)
        # reference parity (optimizer.py:544-563): self pairs already
        # overlapping at the zero pose are coarse-capsule artifacts —
        # warn and ignore them, or every trajectory is "infeasible"
        zero_viol = [
            (a, b)
            for (a, b), d in cm.find_colliding_at_zero()
            if b not in cm.world_boxes
        ]
        if zero_viol:
            print(
                f"ignoring {len(zero_viol)} capsule pair(s) overlapping at "
                f"zero pose: {zero_viol[:6]}{'...' if len(zero_viol) > 6 else ''}"
            )
            cfg2 = dict(config)
            cfg2["ignoreLinkPairsForCollision"] = list(
                config.get("ignoreLinkPairsForCollision", []) or []
            ) + [list(p) for p in zero_viol]
            cm = CollisionModel(
                model.tree, model.engine, cfg2, world_tree=world_tree
            )
        if cm.num_pairs:
            n_trans = (
                int(config.get("transitionCollisionSamples", 10))
                if float(config.get("transitionDuration", 3.0)) > 0
                else 0
            )
            extra_fn = cm.trajectory_constraint_fn(
                step=int(config.get("collisionCheckStep", 3)),
                n_transition=n_trans,
            )

    obj = TrajectoryObjective(
        model, config, spec, yty_prior=yty_prior, extra_constraints_fn=extra_fn,
        n_extra_constraints=(cm.num_pairs if extra_fn is not None else None),
    )
    x0 = initial_candidate(spec, config, rng)
    obj.calibrate_scale(x0)

    info = {"n_collision_pairs": cm.num_pairs if cm is not None else 0}
    x = x0
    feas = False
    _ts = time.time()
    with InterruptGuard() as guard:
        if config.get("useGlobalOptimization", 1):
            x, f, feas = global_search(obj, config, seeds=seeds, rng=rng,
                                       should_stop=guard)
            info["global_f"] = f
            info["global_feasible"] = feas
        info["t_global_s"] = round(time.time() - _ts, 3)
        _ts = time.time()
        if config.get("useLocalOptimization", 1) and not guard():
            x, f, feas = local_refine_batch(obj, config, x, rng=rng,
                                            should_stop=guard)
            info["local_f"] = f
            info["local_feasible"] = feas
        info["t_local_s"] = round(time.time() - _ts, 3)
        _ts = time.time()
        info["interrupted"] = guard()

        # dense mesh-tier verification of the winning candidate
        # (reference sparse-then-dense pattern, optimizer.py:1099-1132):
        # capsules are the differentiable optimizer geometry; the exact
        # convex-hull pass must ALSO hold before feasibility is declared
        mode = str(config.get("collisionMode", "convex"))
        if cm is not None and cm.num_pairs and mode != "capsule" and not guard():
            from ..collision_mesh import MeshCollisionVerifier

            ver = MeshCollisionVerifier(model.tree, model.engine, config, cm,
                                        world_tree=world_tree, device=model.device)
            if ver.num_pairs:
                step_v = int(config.get("collisionCheckStep", 3))
                Q, BR, BP = obj.kinematics(x)
                ok, bad = ver.verify(Q, base_rot=BR, base_pos=BP, step=step_v)
                info["mesh_collision_ok"] = bool(ok)
                if not ok:
                    x, ok, bad = _mesh_backoff_refine(
                        config, spec, obj, cm, ver, x, bad, guard, info, n_trans, step_v)
                    info["mesh_collision_ok"] = bool(ok)
                    if not ok:
                        print(f"mesh verification still failing: {bad[:4]}")
        info["t_mesh_s"] = round(time.time() - _ts, 3)
    if not info.get("interrupted"):
        # a finished run invalidates its mid-optimization checkpoint
        # (an interrupted one keeps it so the next run resumes)
        Checkpoint(config, spec.dim).clear()
    fv, gv, n_obs = obj.evaluate(x)
    info.update(f=fv, max_violation=float(np.max(gv)),
                feasible=obj.feasible(gv) and info.get("mesh_collision_ok", True),
                n_observable=int(n_obs))
    return x, spec, obj, info
