"""Entry points of the port: one step of the flagship model,
and a dry run of the production sharded paths.

Counterpart of the JAX package's root `__graft_entry__.py`:

  * `entry(device)` -> (fn, example_args): the batched regressor of the
    7-DOF arm, its Gram (through the Gram kernel, `ops.gram`) and the
    inverse-dynamics torques;
  * `dryrun_multichip(n_devices, device)` runs the five production
    sharded paths at tiny shapes, each against its unsharded run in this
    process: the streamed identify (`shardSamples`), the walking-contact
    identify of humanoid30 (floating base, foot wrenches), one CEM
    generation (`shardCandidates`), the structural random Gram and one
    augmented-Lagrangian restart batch. It prints one line with the
    parities and returns them.

Run as `python -m flobaroid_tpu_torch.parallel.dryrun [--devices N]
[--device cpu]`: on the card by default, with one shard per card (at
least two: several shards share a card when there are fewer).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")


def entry(device="cuda"):
    """(fn, (Q, DQ, DDQ)): fn gives the arm's Gram Y^T Y (P, P) and the
    torques Y @ pi (N, n) of 256 random states on `device`, in f32."""
    from ..device import resolve_device
    from ..dynamics.engine import DynamicsEngine
    from ..models.urdf import load_urdf
    from ..ops.gram import gram_batched

    dev = resolve_device(device)
    tree = load_urdf(ARM_URDF)
    eng = DynamicsEngine(tree)
    pi = torch.as_tensor(tree.std_params(), dtype=torch.float32, device=dev)
    P = tree.num_links * 10

    def fn(Q, DQ, DDQ):
        Y = eng.regressor_batch(Q, DQ, DDQ)  # (N, n, P)
        G = gram_batched(Y.reshape(-1, 1, P))[0]
        return G, Y @ pi

    N, n = 256, tree.num_dofs
    rng = np.random.default_rng(0)
    args = (rng.uniform(-1, 1, (N, n)), rng.normal(size=(N, n)), rng.normal(size=(N, n)))
    return fn, tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in args)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The five production sharded paths with `n_devices` shards, each
    held against its unsharded run: relative error of xBase (identify,
    walking), of the structural Gram, and the CEM values and constraints
    and AL restart results (f64 on the CPU: 1e-8; f32 on the card: 1e-4,
    the chip script's gates). Raises on a parity miss; returns the
    parities."""
    from ..device import resolve_device
    from ..excitation.objective import TrajectoryObjective
    from ..excitation.optimizer import build_bounds, global_search, local_refine_batch
    from ..excitation.trajectory import FourierSpec
    from ..identification.identifier import Identification
    from ..model import Model
    from ..simulation.scenarios import walking_contact_scenario
    from ..utils.config import load_config

    dev = resolve_device(device)
    n_devices = int(n_devices)
    f64 = dev.type == "cpu"
    tol = 1e-8 if f64 else 1e-4
    tdt = torch.float64 if f64 else torch.float32

    def check(err: float, what: str) -> None:
        if not err < tol:
            raise AssertionError(f"{what}: sharded vs unsharded rel err {err:.3g} >= {tol:g}")

    def base_opt(**over):
        o = load_config(None, overrides=dict(
            floatingBase=0, simulateTorques=1, useStructuralRegressor=1,
            randomSamples=500, estimateWith="std", constrainToConsistent=0,
            materializeRegressor=0, gramChunk=128,
            computeDtype="float64" if f64 else "float32", verbose=0))
        o.update(over)
        return o

    out = dict(n_devices=n_devices, device=str(dev))
    tmpdir = tempfile.mkdtemp(prefix="flobaroid_torch_dryrun_")
    try:
        urdf = os.path.join(tmpdir, "sevenlink_arm.urdf")
        shutil.copy(ARM_URDF, urdf)
        # tiny but real dataset: random states within limits
        rng = np.random.default_rng(0)
        probe = Model(base_opt(), urdf, device=dev)
        n = probe.num_dofs
        lims = probe.limits
        lo = np.array([lims[j]["lower"] for j in probe.jointNames])
        hi = np.array([lims[j]["upper"] for j in probe.jointNames])
        N = 512
        samples = {
            "positions": lo + (hi - lo) * rng.random((N, n)),
            "velocities": (rng.random((N, n)) - 0.5) * 2,
            "accelerations": (rng.random((N, n)) - 0.5) * 2,
            "torques": np.zeros((N, n)),
            "times": np.arange(N) / 200.0,
            "frequency": np.float64(200.0),
        }

        # the streamed identify, sample axis sharded
        xb = {}
        for shards in (n_devices, 0):
            idf = Identification(base_opt(shardSamples=shards), urdf, device=dev)
            idf.data.init_from_data(dict(samples))
            idf.estimateParameters()
            xb[shards] = np.asarray(idf.model.xBase)
        out["identify_rel_err"] = _rel(xb[n_devices], xb[0])
        check(out["identify_rel_err"], "streamed identify")

        # floating base + foot contact wrenches through the streamed
        # pipeline, sample axis sharded
        urdf30 = os.path.join(tmpdir, "humanoid30.urdf")
        shutil.copy(H30_URDF, urdf30)
        shutil.copy(H30_URDF + ".regressor.npz", urdf30 + ".regressor.npz")

        def walk_opt(shards):
            return base_opt(
                floatingBase=1, simulateTorques=0, identifyFrictionSimultaneously=1,
                identifySymmetricVelFriction=1, randomSamples=2000,
                gramChunk=(96 // n_devices) * n_devices or n_devices, shardSamples=shards)

        gen = Identification(walk_opt(0), urdf30, device=dev)
        # the identification sample guard needs N > 2 * 430 identified params
        wsamples, _, _ = walking_contact_scenario(
            gen.model, N=896, freq=200.0, seed=5, torque_noise=0.02, wrench_noise=0.3)
        xw = {}
        for shards in (n_devices, 0):
            idf = Identification(walk_opt(shards), urdf30, device=dev)
            idf.data.init_from_data(dict(wsamples))
            idf.estimateParameters()
            xw[shards] = np.asarray(idf.model.xBase)
        out["walking_rel_err"] = _rel(xw[n_devices], xw[0])
        check(out["walking_rel_err"], "walking-contact identify")

        # one CEM generation, candidate batch sharded, and the batch's
        # values and constraints against the unsharded evaluation. The
        # trajectories are 2 s at 50 Hz: the JAX dry run asks for that
        # with keys no objective reads (trajectoryDuration,
        # trajectorySamplingRate) and samples one slowest period at
        # 200 Hz instead
        opt_t = base_opt(
            excitationFrequency=50.0, checkCollisions=0,
            globalOptSize=2 * n_devices, globalOptIterations=1, globalOptRestarts=1,
            globalOptAmplitudeRepair=0)
        m = Model(dict(opt_t), urdf, device=dev)
        limits = tuple((float(lims[j]["lower"]), float(lims[j]["upper"])) for j in m.jointNames)
        spec = FourierSpec(nf=tuple(2 for _ in m.jointNames), limits=limits)
        obj = TrajectoryObjective(m, dict(opt_t), spec, duration=2.0, dtype=tdt)
        blo, bhi = build_bounds(spec, opt_t)
        X = blo + (bhi - blo) * rng.random((2 * n_devices + 1, len(blo)))
        obj.calibrate_scale(X[0])
        f0, g0, n0 = obj.evaluate_batch(X)
        obj.config["shardCandidates"] = n_devices
        f1, g1, n1 = obj.evaluate_batch(X)
        out["cem_f_rel_err"] = float(np.abs(f1 - f0).max() / np.abs(f0).max())
        out["cem_g_rel_err"] = float(np.abs(g1 - g0).max() / np.abs(g0).max())
        check(out["cem_f_rel_err"], "CEM values")
        check(out["cem_g_rel_err"], "CEM constraints")
        if not np.array_equal(n1, n0):
            raise AssertionError(f"CEM n_obs: sharded {n1}, unsharded {n0}")
        best_x, best_f, best_feas = global_search(obj, dict(obj.config),
                                                  rng=np.random.default_rng(1))
        if not (np.all(np.isfinite(best_x)) and np.isfinite(best_f)):
            raise AssertionError("sharded CEM generation: non-finite result")
        out.update(cem_best_f=float(best_f), cem_feasible=bool(best_feas))

        # the structural random Gram: the same draws, sharded
        m_sh = Model(base_opt(shardSamples=n_devices), urdf, device=dev)
        G_sh, G_1 = m_sh._random_gram(256), probe._random_gram(256)
        out["random_gram_rel_err"] = _rel(G_sh, G_1)
        check(out["random_gram_rel_err"], "structural random Gram")

        # one augmented-Lagrangian stage of n restarts, restart axis sharded
        obj.config.update(localOptRestarts=n_devices, localOptStages=1, localOptIterations=1)
        al = {}
        for shards in (n_devices, 0):
            obj.config["shardCandidates"] = shards
            al[shards] = local_refine_batch(obj, dict(obj.config), best_x,
                                            rng=np.random.default_rng(2))
        xr, fr, feasr = al[n_devices]
        if not (np.all(np.isfinite(xr)) and np.isfinite(fr)):
            raise AssertionError("sharded AL restart batch: non-finite result")
        out["al_x_rel_err"] = _rel(xr, al[0][0])
        check(out["al_x_rel_err"], "AL restart batch")
        out.update(al_f=float(fr), al_feasible=bool(feasr))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(
        f"dryrun_multichip OK on {n_devices} shards ({dev}): production streamed identify "
        f"sharded-vs-single rel err {out['identify_rel_err']:.2e}; walking-contact "
        f"(floating base + contact J^T w) sharded rel err {out['walking_rel_err']:.2e}; "
        f"CEM generation (pop {2 * n_devices}, sharded candidates) best_f={best_f:.3f} "
        f"feasible={best_feas}; structural random-Gram sharded rel err "
        f"{out['random_gram_rel_err']:.2e}; AL restart batch (K={n_devices}, sharded) "
        f"f={fr:.3f} feasible={feasr}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.parallel.dryrun")
    p.add_argument("--devices", type=int, default=None,
                   help="shards (default: the visible cards, at least 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device type of the run (default: cuda; cpu on request)")
    args = p.parse_args(argv)
    fn, ex = entry(args.device)
    G, tau = fn(*ex)
    print("entry OK:", tuple(G.shape), tuple(tau.shape))
    n = args.devices
    if n is None:
        n = max(2, torch.cuda.device_count() if args.device.startswith("cuda") else 2)
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
