"""The port's capsule collision model against the JAX package, CPU, f64.

Inputs come from numpy seeds and go through `flobaroid_tpu.collision` and
`flobaroid_tpu_torch.collision`. Tolerances: the closed-form segment and
box distances, `CollisionModel.distances` and `trajectory_constraint_fn`
(on the 7-DOF arm with a world box, and on humanoid30 with swung base
poses) agree to 1e-10 absolute (metres; measured ~1e-16: the same f64
operations in another order); the capsule fits and the pair lists are
equal; the constraint's gradient agrees with `jax.grad` to 1e-8 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu import collision as jcol
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu_torch import collision as tcol
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine, rpy_to_base_rot
from flobaroid_tpu_torch.models.urdf import load_urdf

from test_collision import WORLD_URDF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
TOL = 1e-10


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _models(urdf, world=None, **cfg):
    """(JAX, port) CollisionModel of one URDF with one configuration."""
    opt = load_config(None, overrides=cfg)
    jt, tt = jax_load_urdf(urdf), load_urdf(urdf)
    jw = jax_load_urdf(world) if world else None
    tw = load_urdf(world) if world else None
    return (jcol.CollisionModel(jt, JaxEngine(jt), opt, world_tree=jw),
            tcol.CollisionModel(tt, DynamicsEngine(tt), opt, world_tree=tw))


@pytest.fixture(scope="module")
def arm_models():
    return _models(ARM_URDF, world=WORLD_URDF, worldCollisionDefaultMargin=0.01)


@pytest.fixture(scope="module")
def h30_models():
    return _models(H30_URDF)


def _segments(rng, n):
    """n random segment pairs, then the degenerate cases: a point second
    segment, a point first segment, two points, parallel, crossing."""
    P = rng.uniform(-1, 1, (4, n, 3))
    extra = np.array([
        [[0, 0, 0], [1, 0, 0], [0.5, 0.05, 0], [0.5, 0.05, 0]],
        [[0.5, 0.05, 0], [0.5, 0.05, 0], [0, 0, 0], [1, 0, 0]],
        [[0, 0, 0], [0, 0, 0], [0, 0, 2], [0, 0, 2]],
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
        [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0]],
        [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]],
    ], dtype=float).transpose(1, 0, 2)
    return np.concatenate([P, extra], axis=1)


def test_segment_segment_distance_matches_jax():
    p1, q1, p2, q2 = _segments(np.random.default_rng(0), 200)
    want = np.asarray(jax.vmap(jcol.segment_segment_distance)(
        *(jnp.asarray(a) for a in (p1, q1, p2, q2))))
    got = tcol.segment_segment_distance(T(p1), T(q1), T(p2), T(q2)).numpy()
    assert np.abs(got - want).max() <= TOL
    assert abs(got[200] - 0.05) < 1e-9 and abs(got[201] - 0.05) < 1e-9  # sphere capsules


def test_segment_segment_gradient_matches_jax():
    p1, q1, p2, q2 = _segments(np.random.default_rng(1), 50)
    jg = np.asarray(jax.vmap(jax.grad(jcol.segment_segment_distance, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (p1, q1, p2, q2))))
    ts = [T(a).requires_grad_(True) for a in (p1, q1, p2, q2)]
    tcol.segment_segment_distance(*ts).sum().backward()
    tg = np.stack([t.grad.numpy() for t in ts])
    assert np.all(np.isfinite(tg))
    assert np.abs(tg - jg).max() <= 1e-8


@pytest.mark.parametrize("oriented", [False, True], ids=["axis_aligned", "oriented"])
def test_box_distances_match_jax(oriented):
    rng = np.random.default_rng(2)
    n = 60
    p0, p1, c = rng.uniform(-1.5, 1.5, (3, n, 3))
    half = rng.uniform(0.1, 0.8, (n, 3))
    R = np.asarray(rpy_to_base_rot(T(rng.uniform(-1, 1, (n, 3))))) if oriented else None
    jR = None if R is None else jnp.asarray(R)
    want_p = np.asarray(jax.vmap(jcol.point_box_distance, in_axes=(0, 0, 0, None if R is None else 0))(
        jnp.asarray(p0), jnp.asarray(c), jnp.asarray(half), jR))
    want_s = np.asarray(jax.vmap(jcol.segment_box_distance, in_axes=(0, 0, 0, 0, None if R is None else 0))(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(c), jnp.asarray(half), jR))
    tR = None if R is None else T(R)
    assert np.abs(tcol.point_box_distance(T(p0), T(c), T(half), tR).numpy() - want_p).max() <= TOL
    assert np.abs(tcol.segment_box_distance(T(p0), T(p1), T(c), T(half), tR).numpy()
                  - want_s).max() <= TOL
    assert (want_p < 0).any() and (want_p > 0).any()  # points inside and outside


@pytest.mark.parametrize("urdf", [ARM_URDF, H30_URDF], ids=["arm", "humanoid30"])
def test_capsule_fits_match_jax(urdf):
    jt, tt = jax_load_urdf(urdf), load_urdf(urdf)
    n = 0
    for name in jt.link_names:
        jc, tc = jcol.fit_capsule(jt, name, scale=1.1), tcol.fit_capsule(tt, name, scale=1.1)
        assert (jc is None) == (tc is None)
        if jc is not None:
            n += 1
            assert np.array_equal(jc.p0, tc.p0) and np.array_equal(jc.p1, tc.p1)
            assert jc.radius == tc.radius
    assert n >= 7


def test_pair_lists_match_jax(arm_models, h30_models):
    for jm, tm in (arm_models, h30_models):
        assert tm.pair_names == jm.pair_names and tm.num_pairs == jm.num_pairs > 0
        assert tm.self_pairs == jm.self_pairs and tm.world_pairs == jm.world_pairs
        assert np.array_equal(tm.margins, jm.margins)
        assert np.array_equal(tm._kin_dist, jm._kin_dist)
    assert len(arm_models[1].world_pairs) == len(arm_models[1].capsules)
    # the configuration's ignore lists and the kinematic-distance cap
    cfg = dict(ignoreLinksForCollision=["arm_7_link"],
               ignoreLinkPairsForCollision=[["arm_1_link", "arm_4_link"]],
               ignoreCollisionBetweenGroups=[[["arm_2_link"], ["arm_5_link", "arm_6_link"]]],
               collisionMaxKinematicDistance=2, scaleCapsuleRadius=1.2)
    jm, tm = _models(ARM_URDF, **cfg)
    assert tm.pair_names == jm.pair_names and 0 < tm.num_pairs < arm_models[1].num_pairs
    assert ("arm_1_link", "arm_4_link") not in tm.pair_names


def _base_poses(rng, n):
    """Small swings of a suspended base: world_R_base and positions."""
    rpy = rng.uniform(-0.3, 0.3, (n, 3))
    return np.asarray(rpy_to_base_rot(T(rpy))), rng.uniform(-0.2, 0.2, (n, 3))


def test_distances_match_jax(arm_models, h30_models):
    rng = np.random.default_rng(3)
    for (jm, tm), with_base in ((arm_models, False), (h30_models, True), (h30_models, False)):
        n = jm.tree.num_dofs
        Q = rng.uniform(-1.0, 1.0, (6, n))
        BR, BP = _base_poses(rng, 6) if with_base else (None, None)
        got = tm.distances(T(Q), None if BR is None else T(BR), None if BP is None else T(BP))
        assert got.shape == (6, jm.num_pairs)
        if with_base:
            want = jax.jit(jax.vmap(jm.distances))(jnp.asarray(Q), jnp.asarray(BR), jnp.asarray(BP))
        else:
            want = jax.jit(jax.vmap(lambda q: jm.distances(q)))(jnp.asarray(Q))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
        one = tm.distances(T(Q[0]), None if BR is None else T(BR[0]),
                           None if BP is None else T(BP[0]))
        assert torch.equal(one, got[0])


def test_check_and_zero_pose_match_jax(arm_models, h30_models):
    for jm, tm in (arm_models, h30_models):
        assert [p for p, _ in tm.find_colliding_at_zero()] == \
            [p for p, _ in jm.find_colliding_at_zero()]
    jm, tm = arm_models
    q = np.zeros(7)
    q[1], q[3] = 2.0, -2.0  # bent down towards the floor
    (jok, jv), (tok, tv) = jm.check(q, margin=0.3), tm.check(q, margin=0.3)
    assert tok == jok and [p for p, _ in tv] == [p for p, _ in jv] and len(tv) > 0
    assert np.abs(np.array([d for _, d in tv]) - np.array([d for _, d in jv])).max() <= TOL


def _trajectory(rng, N, n):
    t = np.arange(N) / 20.0
    w, ph, a = rng.uniform(1, 3, n), rng.uniform(0, 6, n), rng.uniform(0.2, 0.9, n)
    return a * np.sin(w * t[:, None] + ph)


@pytest.mark.parametrize("case", ["arm_world", "humanoid30", "humanoid30_base", "humanoid30_rot_only"])
def test_trajectory_constraint_fn_matches_jax(arm_models, h30_models, case):
    """Periodic samples at their own base poses plus the min-jerk ramps
    at the representative and extreme-swing poses: g per pair at 1e-10,
    one trajectory and a population of three."""
    rng = np.random.default_rng(4)
    jm, tm = arm_models if case == "arm_world" else h30_models
    N, n = 40, jm.tree.num_dofs
    Qs = [_trajectory(rng, N, n) for _ in range(3)]
    with_base = case in ("humanoid30_base", "humanoid30_rot_only")
    poses = [_base_poses(rng, N) if with_base else (None, None) for _ in range(3)]
    if case == "humanoid30_rot_only":
        poses = [(br, None) for br, _ in poses]
    jfn = jax.jit(jm.trajectory_constraint_fn(step=3, n_transition=4))
    tfn = tm.trajectory_constraint_fn(step=3, n_transition=4)
    want = np.stack([np.asarray(jfn(jnp.asarray(Q), *(None if p is None else jnp.asarray(p)
                                                      for p in pose)))
                     for Q, pose in zip(Qs, poses)])
    br = None if poses[0][0] is None else T(np.stack([p[0] for p in poses]))
    bp = None if poses[0][1] is None else T(np.stack([p[1] for p in poses]))
    got = tfn(T(np.stack(Qs)), br, bp)
    assert got.shape == (3, jm.num_pairs)
    assert np.abs(got.numpy() - want).max() <= TOL
    one = tfn(T(Qs[1]), None if br is None else br[1], None if bp is None else bp[1])
    assert np.abs(one.numpy() - want[1]).max() <= TOL
    # the plain periodic constraint (no ramps) and its step
    want_c = np.asarray(jm.constraint_fn(step=2)(jnp.asarray(Qs[0])))
    assert np.abs(tm.constraint_fn(step=2)(T(Qs[0])).numpy() - want_c).max() <= TOL


def test_trajectory_constraint_gradient_matches_jax(h30_models):
    """d(sum of g)/dQ through the swung poses, the time minima and the
    extreme-swing argmax: 1e-8 relative. humanoid30 has self pairs only,
    which a common translation does not move: d/d(base position) is zero
    to rounding in both packages."""
    rng = np.random.default_rng(5)
    jm, tm = h30_models
    N, n = 24, jm.tree.num_dofs
    Q = _trajectory(rng, N, n)
    BR, BP = _base_poses(rng, N)
    jfn = jm.trajectory_constraint_fn(step=2, n_transition=3)
    jgq, jgp = jax.jit(jax.grad(lambda q, p: jnp.sum(jfn(q, jnp.asarray(BR), p)), argnums=(0, 1)))(
        jnp.asarray(Q), jnp.asarray(BP))
    tq, tp = T(Q).requires_grad_(True), T(BP).requires_grad_(True)
    tm.trajectory_constraint_fn(step=2, n_transition=3)(tq, T(BR), tp).sum().backward()
    want = np.asarray(jgq)
    assert np.linalg.norm(tq.grad.numpy() - want) <= 1e-8 * np.linalg.norm(want)
    assert np.linalg.norm(want) > 1e-3
    assert np.abs(tp.grad.numpy()).max() <= 1e-12 and np.abs(np.asarray(jgp)).max() <= 1e-12
