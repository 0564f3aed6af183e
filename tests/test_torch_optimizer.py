"""The port's trajectory optimizer against the JAX package, on the CPU in
f64, on the objectives of test_torch_trajectory.py (the 7-DOF arm with
friction and Stribeck columns and capsule collision constraints, 125
samples, 2 harmonics a joint).

Tolerances. Ten Adam steps (`al_refine`, `adam_refine`), one CEM
generation and one `local_refine_batch` stage from the same rng: 1e-6
absolute in x (Adam divides by sqrt(v) + 1e-8, which magnifies rounding
on coordinates with tiny gradients; measured ~1e-9 after ten steps).
Checkpoints, the interrupt guard, the options that raise, one whole
small optimization and the process that loads no JAX are the port's
alone.
"""

import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from flobaroid_tpu.excitation import optimizer as jopt
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch.excitation import optimizer as topt
from flobaroid_tpu_torch.excitation import trajectory as ttraj
from flobaroid_tpu_torch.excitation.objective import TrajectoryObjective
from flobaroid_tpu_torch.model import Model

from test_torch_trajectory import ARM_URDF, REPO, arm  # noqa: F401  (arm: a module fixture)

torch.set_num_threads(2)


@pytest.mark.timeout(180)
@pytest.mark.parametrize("which", ["al_refine", "adam_refine"])
def test_ten_adam_steps_match_jax(arm, which):
    """From a start off the q0 = 0 kink: there the gradient is zero to
    rounding and Adam's first normalized steps follow the rounding's sign,
    in either package."""
    if which == "al_refine":
        args = (arm.X[1], arm.lo, arm.hi, arm.LAM[1], 10.0)
    else:
        args = (arm.X[1], arm.lo, arm.hi, 10.0)
    jx, jv = getattr(arm.jobj, which)(*args, lr=0.01, n_steps=10)
    tx, tv = getattr(arm.tobj, which)(*args, lr=0.01, n_steps=10)
    assert np.abs(tx - jx).max() <= 1e-6 and abs(tv - jv) <= 1e-6 * abs(jv)
    assert np.abs(tx - arm.X[1]).max() > 0.05  # ten steps of 0.01 moved it


@pytest.mark.timeout(180)
def test_one_cem_generation_matches_jax(arm):
    """One generation of 8 candidates from the same rng: the same best
    candidate and score; the helpers draw the same numbers."""
    jx, jf, jfeas = jopt.global_search(arm.jobj, arm.opt, rng=np.random.default_rng(3),
                                       seeds=[arm.X[1]])
    tx, tf, tfeas = topt.global_search(arm.tobj, arm.opt, rng=np.random.default_rng(3),
                                       seeds=[arm.X[1]])
    assert np.abs(tx - jx).max() <= 1e-6 and abs(tf - jf) <= 1e-6 * abs(jf) and tfeas == jfeas
    for a, b in zip(topt.build_bounds(arm.tobj.spec, arm.opt), jopt.build_bounds(arm.jobj.spec, arm.opt)):
        assert np.array_equal(a, b)
    assert np.array_equal(topt.initial_candidate(arm.tobj.spec, arm.opt, np.random.default_rng(9)),
                          jopt.initial_candidate(arm.jobj.spec, arm.opt, np.random.default_rng(9)))
    hot = arm.x0.copy()
    hot[8:] *= 3.0
    (jr, jok), (tr, tok) = jopt.amplitude_repair(arm.jobj, hot), topt.amplitude_repair(arm.tobj, hot)
    assert tok == jok and np.array_equal(tr, jr)


@pytest.mark.timeout(240)
def test_one_local_refine_batch_stage_matches_jax(arm):
    """Two restarts (the amplitude ladder and its jitter from the same
    rng), one augmented-Lagrangian stage of 40 Adam steps."""
    jx, jf, jfeas = jopt.local_refine_batch(arm.jobj, arm.opt, arm.X[1], rng=np.random.default_rng(4))
    tx, tf, tfeas = topt.local_refine_batch(arm.tobj, arm.opt, arm.X[1], rng=np.random.default_rng(4))
    assert tfeas == jfeas
    assert np.abs(tx - jx).max() <= 1e-6 and abs(tf - jf) <= 1e-6 * abs(jf)


# ----------------------------------------------------------------------
# module 4: checkpoints, interrupts, the whole optimization
# ----------------------------------------------------------------------
def test_global_search_interrupt_returns_best_so_far(arm):
    calls = {"n": 0}

    def stop_after_two():
        calls["n"] += 1
        return calls["n"] > 2

    cfg = dict(arm.opt, globalOptIterations=5, globalOptRestarts=2)
    x, f, feas = topt.global_search(arm.tobj, cfg, should_stop=stop_after_two)
    assert x is not None and np.all(np.isfinite(x)) and np.isfinite(f)
    assert calls["n"] == 3  # two generations ran, the third poll stopped it


def test_local_refine_interrupt_returns_start(arm):
    x0 = topt.initial_candidate(arm.tobj.spec, arm.opt, np.random.default_rng(1))
    x, f, feas = topt.local_refine(arm.tobj, arm.opt, x0, should_stop=lambda: True)
    assert np.all(np.isfinite(x))


def test_checkpoint_resume_preserves_seeds(tmp_path):
    """A run killed BEFORE the seeded generation evaluates (the
    checkpoint saves pre-evaluation) re-injects the seed solutions on
    resume even when the resuming caller does not pass them again."""
    spec = ttraj.FourierSpec(nf=(1, 1), limits=((-1.0, 1.0), (-1.0, 1.0)))
    cfg = dict(globalOptSize=8, globalOptIterations=2, globalOptRestarts=1,
               globalOptAmplitudeRepair=0,
               trajectoryCheckpointFile=str(tmp_path / "seed_ckpt.npz"))
    lo, hi = topt.build_bounds(spec, cfg)
    seed = lo + 0.3717 * (hi - lo)

    class StubObj:
        def __init__(self, die_on_first=False):
            self.spec = spec
            self.rows = []
            self.die = die_on_first

        def evaluate_batch(self, X):
            if self.die:
                self.die = False
                raise RuntimeError("simulated kill mid-generation")
            X = np.asarray(X, float)
            self.rows.append(X.copy())
            return np.sum((X - 0.1) ** 2, axis=1), -np.ones((len(X), 1)), np.zeros(len(X), int)

        def evaluate(self, x):
            f, g, n = self.evaluate_batch(np.asarray(x)[None, :])
            return float(f[0]), g[0], int(n[0])

        def feasible(self, g):
            return bool(np.all(np.asarray(g) <= 0))

    with pytest.raises(RuntimeError):
        topt.global_search(StubObj(die_on_first=True), cfg, seeds=[seed],
                           rng=np.random.default_rng(11))
    assert os.path.exists(cfg["trajectoryCheckpointFile"])
    obj2 = StubObj()
    topt.global_search(obj2, cfg, rng=np.random.default_rng(999))
    evaluated = np.concatenate(obj2.rows)
    assert np.min(np.linalg.norm(evaluated - np.clip(seed, lo, hi), axis=1)) < 1e-12


def test_checkpoint_save_load_and_resume(tmp_path):
    """Atomic save, phase and dimension guards, the rng state, and a
    resumed search that reproduces the uninterrupted one exactly."""
    path = str(tmp_path / "ckpt.npz")
    ck = topt.Checkpoint(dict(trajectoryCheckpointFile=path), dim=5)
    assert ck.load("global") is None
    rng = np.random.default_rng(2)
    rng.standard_normal(3)
    ck.save("global", r=1, it=2, mean=np.arange(5.0), rng_state=topt.Checkpoint.pack_rng(rng))
    assert not os.path.exists(path + ".tmp.npz")
    got = ck.load("global")
    assert int(got["r"]) == 1 and int(got["it"]) == 2 and np.array_equal(got["mean"], np.arange(5.0))
    assert ck.load("local") is None
    assert topt.Checkpoint(dict(trajectoryCheckpointFile=path), dim=6).load("global") is None
    fresh = np.random.default_rng(77)
    topt.Checkpoint.restore_rng(fresh, got["rng_state"])
    assert fresh.standard_normal() == rng.standard_normal()
    ck.clear()
    assert not os.path.exists(path)
    assert topt.Checkpoint({}, dim=5).load("global") is None  # no file configured: a no-op
    topt.Checkpoint({}, dim=5).save("global", r=0)

    spec = ttraj.FourierSpec(nf=(1, 1), limits=((-1.0, 1.0), (-1.0, 1.0)))

    class Quadratic:
        def __init__(self):
            self.spec = spec

        def evaluate_batch(self, X):
            X = np.asarray(X, float)
            return np.sum((X - 0.1) ** 2, axis=1), X[:, 1:2] - 0.2, np.zeros(len(X), int)

        def evaluate(self, x):
            f, g, n = self.evaluate_batch(np.asarray(x)[None, :])
            return float(f[0]), g[0], int(n[0])

        def feasible(self, g):
            return bool(np.all(np.asarray(g) <= 0))

    cfg = dict(globalOptSize=8, globalOptIterations=4, globalOptRestarts=2,
               globalOptAmplitudeRepair=0, trajectoryCheckpointFile=path)
    x_ref, f_ref, _ = topt.global_search(Quadratic(), dict(cfg, trajectoryCheckpointFile=""),
                                         rng=np.random.default_rng(7))
    calls = {"n": 0}
    topt.global_search(Quadratic(), cfg, rng=np.random.default_rng(7),
                       should_stop=lambda: calls.__setitem__("n", calls["n"] + 1) or calls["n"] > 3)
    assert os.path.exists(path)
    x2, f2, _ = topt.global_search(Quadratic(), cfg, rng=np.random.default_rng(999))
    assert np.array_equal(x2, x_ref) and f2 == f_ref


def test_interrupt_guard_keeps_to_sigint():
    """The guard turns SIGINT into a flag and restores the handler it
    found; it leaves SIGALRM (the tests' per-test cap) alone."""
    before_int, before_alrm = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGALRM)
    with topt.InterruptGuard() as guard:
        assert signal.getsignal(signal.SIGALRM) is before_alrm
        assert signal.getsignal(signal.SIGINT) is not before_int
        assert not guard()
        os.kill(os.getpid(), signal.SIGINT)
        assert guard() and guard.hit
    assert signal.getsignal(signal.SIGINT) is before_int
    assert signal.getsignal(signal.SIGALRM) is before_alrm


def test_unported_options_raise(arm):
    """Candidate sharding is not ported: the optimizer and the objective
    say so, naming ROADMAP, before any work is done, whatever the
    collision mode (the exact-mesh tier is ported)."""
    model = arm.tobj.model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.optimize_trajectory(model, dict(arm.opt, collisionMode="convex", shardCandidates=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.optimize_trajectory(model, dict(arm.opt, shardCandidates=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrajectoryObjective(model, dict(arm.opt, shardCandidates=2), arm.tobj.spec)
    with pytest.raises(RuntimeError, match="calibrate_scale"):
        TrajectoryObjective(model, arm.opt, arm.tobj.spec).evaluate(arm.x0)


@pytest.mark.timeout(240)
def test_optimize_trajectory_improves(tmp_path):
    """One whole small run of the port alone (f32 chain on the CPU): it
    ends feasible, below its amplitude-repaired start, inside the limits
    on a fine resampling, and leaves no checkpoint behind."""
    urdf = str(tmp_path / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    ckpt = str(tmp_path / "ckpt.npz")
    opt = load_config(None, overrides=dict(
        floatingBase=0, useStructuralRegressor=1, randomSamples=800, computeDtype="float64",
        excitationFrequency=50.0, trajectoryPulseMin=1.0, trajectoryPulseMax=2.0,
        trajectoryDefaultNf=3, globalOptSize=8, globalOptIterations=4, localOptIterations=2,
        trajectoryCheckpointFile=ckpt, verbose=0))
    model = Model(opt, urdf, device="cpu")
    x, spec, obj, info = topt.optimize_trajectory(model, dict(opt))
    assert info["feasible"] and not info["interrupted"], info
    assert info["n_collision_pairs"] == 15 and not os.path.exists(ckpt)
    x0r, ok = topt.amplitude_repair(obj, topt.initial_candidate(spec, opt, np.random.default_rng(0)))
    f0, _, n0 = obj.evaluate(x0r)
    assert info["f"] <= f0 + 1e-6 and info["n_observable"] >= n0
    t = np.arange(int(50.0 * 2 * np.pi / x[0])) / 50.0
    Q, V, _ = (a.numpy() for a in ttraj.fourier_traj(spec, torch.as_tensor(x), t))
    lims = model.limits
    lo = np.array([lims[j]["lower"] for j in model.jointNames])
    hi = np.array([lims[j]["upper"] for j in model.jointNames])
    vl = np.array([lims[j]["velocity"] for j in model.jointNames])
    assert np.all(Q >= lo - 1e-6) and np.all(Q <= hi + 1e-6) and np.all(np.abs(V) <= vl * 1.02)


@pytest.mark.timeout(180)
def test_port_loads_no_jax_after_optimize_and_simulate(tmp_path):
    """A CPU optimize and a CPU simulate in a fresh process load no jax,
    no optax and no flobaroid_tpu module."""
    urdf = tmp_path / "arm.urdf"
    shutil.copy(ARM_URDF, urdf)
    code = f"""
import sys
import numpy as np
sys.path.insert(0, {REPO!r})
from flobaroid_tpu_torch.excitation.optimizer import optimize_trajectory
from flobaroid_tpu_torch.excitation.trajectory import fourier_traj
from flobaroid_tpu_torch.model import Model
from flobaroid_tpu_torch.simulation.simulator import MEASUREMENT_KEYS, simulate_measurements
from flobaroid_tpu_torch.utils.config import load_config
import torch
opt = load_config(None, overrides=dict(floatingBase=0, useStructuralRegressor=1, randomSamples=300,
    excitationFrequency=20.0, trajectoryPulseMin=1.0, trajectoryPulseMax=2.0, trajectoryDefaultNf=2,
    globalOptSize=8, globalOptIterations=2, localOptIterations=1, localOptStages=1,
    localOptRestarts=2, verbose=0))
model = Model(opt, {str(urdf)!r}, device="cpu")
x, spec, obj, info = optimize_trajectory(model, dict(opt))
assert np.all(np.isfinite(x)) and np.isfinite(info["f"])
t = np.arange(100) / 20.0
Q, V, A = (a.numpy() for a in fourier_traj(spec, torch.as_tensor(x), t))
cfg = dict(opt, urdf={str(urdf)!r}, num_dofs=model.num_dofs, jointNames=model.jointNames)
meas = simulate_measurements(cfg, dict(times=t, positions=Q, velocities=V, accelerations=A),
                             device="cpu")
assert set(meas) == MEASUREMENT_KEYS and np.all(np.isfinite(meas["torques"]))
print("jax" in sys.modules, "optax" in sys.modules,
      any(m == "flobaroid_tpu" or m.startswith("flobaroid_tpu.") for m in sys.modules))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=170, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-3:] == ["False", "False", "False"]
