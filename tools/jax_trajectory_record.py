"""Figure of record of the JAX package for the trajectory leg of chip_smoke.py.

Runs `flobaroid_tpu.excitation.optimizer.optimize_trajectory` on the CPU with
the configuration of chip_smoke.py's trajectory leg (the 7-DOF arm of
examples/, bench.py's fourth-leg budget, seed 0, capsule collisions) and prints
one JSON line with `neg_logdet`, `base_cond` (bench.py's `dopt_of`) and
`feasible`.  Run it as

    python tools/jax_trajectory_record.py [--size 64] [--restarts 8]
                                          [--seeds 0,1,2] [--jitters 4]

One line is printed per `trajectoryOptSeed` of `--seeds` and per jitter:
jitter j >= 1 starts the local stage a rounding-sized step (1e-6 of the
box, numpy seed 1000 + j) off the global search's winner, which shows how
far a perturbation of rounding's size moves the result.
The figures go into PERF.md as "JAX package, CPU"; chip_smoke.py holds the
port's result on the card against them.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--jitters", default="0", help="comma list of jitter indices, 0 = none")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from flobaroid_tpu.data import Data
    import flobaroid_tpu.excitation.optimizer as optimizer_module
    from flobaroid_tpu.excitation.optimizer import optimize_trajectory
    from flobaroid_tpu.excitation.trajectory import fourier_traj
    from flobaroid_tpu.model import Model
    from flobaroid_tpu.utils.config import load_config

    tmp = tempfile.mkdtemp(prefix="flobaroid_jaxrec_")
    urdf = os.path.join(tmp, "sevenlink_arm.urdf")
    shutil.copy(os.path.join(HERE, "examples", "models", "sevenlink_arm.urdf"), urdf)
    opt = load_config(os.path.join(HERE, "examples", "configs", "sevenlink_arm.yaml"))
    opt.update(verbose=0, trajectoryOptSeed=0, checkCollisions=1,
               collisionMode="capsule", parallelCompile=0)
    model = Model(opt, urdf)

    def dopt_of(Q, V, A, times):
        cfg = dict(opt)
        N = len(times)
        samples = {
            "positions": Q, "velocities": V, "accelerations": A,
            "torques": np.zeros((N, model.num_dofs)), "times": times,
            "frequency": np.float64(opt["excitationFrequency"]),
        }
        cfg.update(simulateTorques=True, skipSamples=0, startOffset=0)
        d = Data(cfg)
        d.init_from_data(samples)
        old = dict(model.opt)
        model.opt.update(simulateTorques=True, skipSamples=0, startOffset=0)
        model.computeRegressors(d)
        model.opt.update(
            {k: old[k] for k in ("simulateTorques", "skipSamples", "startOffset")})
        G = model.YBase.T @ model.YBase / N
        ev = np.linalg.eigvalsh(G)
        return (float(-np.sum(np.log(ev + 1e-4 * ev[-1]))),
                float(np.sqrt(ev[-1] / max(ev[0], 1e-300))))

    refine = optimizer_module.local_refine_batch
    jitter = 0

    def jittered_refine(obj, config, x0, rng=None, should_stop=None):
        if jitter:
            lo, hi = optimizer_module.build_bounds(obj.spec, config)
            x0 = x0 + 1e-6 * (hi - lo) * np.random.default_rng(1000 + jitter).standard_normal(len(x0))
        return refine(obj, config, x0, rng=rng, should_stop=should_stop)

    optimizer_module.local_refine_batch = jittered_refine
    freq = float(opt["excitationFrequency"])
    for seed, jitter in ((int(s), int(j)) for s in args.seeds.split(",")
                         for j in args.jitters.split(",")):
        cfg = dict(opt)
        cfg.update(globalOptSize=args.size, globalOptIterations=8, globalOptRestarts=1,
                   localOptIterations=3, localOptStages=5, localOptRestarts=args.restarts,
                   trajectoryOptSeed=seed)
        t0 = time.time()
        x, spec, obj, info = optimize_trajectory(model, cfg)
        wall = time.time() - t0
        tt = np.arange(max(int(2 * np.pi / x[0] * freq), 16)) / freq
        Q, V, A = (np.asarray(v, np.float64) for v in
                   fourier_traj(spec, jnp.asarray(x), tt))
        f, c = dopt_of(Q, V, A, tt)
        print(json.dumps({
            "package": "flobaroid_tpu (JAX, CPU)", "seed": seed, "jitter": jitter,
            "size": args.size, "restarts": args.restarts,
            "neg_logdet": f, "base_cond": c, "feasible": bool(info["feasible"]),
            "max_violation": float(info["max_violation"]), "f": float(info["f"]),
            "n_samples": len(tt), "pulse": float(x[0]),
            "cpu_seconds_not_a_target": round(wall, 1),
            "x": [float(v) for v in x],
        }), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
