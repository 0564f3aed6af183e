"""The port's exact-mesh collision tier against the JAX package, CPU.

Inputs come from numpy seeds and the geometries of
`tests/test_collision_mesh.py` and `tests/test_geometry_dae.py`, and go
through `flobaroid_tpu.collision_mesh` / `native_meshdist` /
`models.geometry` and their counterparts in `flobaroid_tpu_torch`.
Tolerances: `polytope_distance` in f64 agrees with JAX's to 1e-10
(metres; the same 300 projected-gradient steps in another operation
order); the host-side vertex clouds, triangle soups and mesh readers are
exactly equal; `MeshCollisionVerifier` (float32 in both packages)
agrees to 1e-5 m per sample and pair with identical verdicts; the native
library built by the port gives the JAX binding's distances to 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flobaroid_tpu import collision_mesh as jcm
from flobaroid_tpu import native_meshdist as jnm
from flobaroid_tpu.collision import CollisionModel as JaxCollisionModel
from flobaroid_tpu.dynamics.engine import DynamicsEngine as JaxEngine
from flobaroid_tpu.models import geometry as jgeo
from flobaroid_tpu.models.urdf import load_urdf as jax_load_urdf
from flobaroid_tpu_torch import collision_mesh as tcm
from flobaroid_tpu_torch import native_meshdist as tnm
from flobaroid_tpu_torch.collision import CollisionModel
from flobaroid_tpu_torch.dynamics.engine import DynamicsEngine
from flobaroid_tpu_torch.models import geometry as tgeo
from flobaroid_tpu_torch.models.urdf import load_urdf
from flobaroid_tpu_torch.ops import _build

from test_collision_mesh import CHANNEL_URDF, PLATES_URDF, WORLD_URDF, _box_soup, _box_verts
from test_collision_mesh import _write_stl as _write_stl_soup
from test_geometry_dae import _CUBE_T, _CUBE_V, _dae_text, _write_stl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H30_URDF = os.path.join(REPO, "examples", "models", "humanoid30.urdf")
BASE_CFG = dict(checkCollisions=1, scaleCollisionHull=1.0, meshBaseDir="meshes",
                maxKinematicDistance=0)
TOL_F64 = 1e-10
TOL_VERIFIER = 1e-5


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("case", ["separated", "overlap", "diagonal", "random"])
def test_polytope_distance_matches_jax_f64(case):
    """The separated boxes (three gaps), the overlap and the diagonal gap
    of `tests/test_collision_mesh.py`, and random clouds of unequal size,
    one batched call against JAX's per-problem calls."""
    A = _box_verts([0, 0, 0], [1, 1, 1])
    rng = np.random.default_rng(3)
    if case == "separated":
        Bs = [_box_verts([1.0 + gap, 0, 0], [1, 1, 1]) for gap in (0.05, 0.3, 1.7)]
        As = [A] * 3
    elif case == "overlap":
        As, Bs = [A], [_box_verts([0.6, 0.2, 0.0], [1, 1, 1])]
    elif case == "diagonal":
        As, Bs = [A], [_box_verts([1.2, 1.2, 1.2], [1, 1, 1])]
    else:
        As = [rng.normal(size=(11, 3)) for _ in range(4)]
        Bs = [rng.normal(size=(6, 3)) + rng.normal(size=3) * 2 for _ in range(4)]
    want = np.array([float(jcm.polytope_distance(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(As, Bs)])
    got = tcm.polytope_distance(T(np.stack(As)), T(np.stack(Bs))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F64)
    if case == "separated":
        np.testing.assert_allclose(got, [0.05, 0.3, 1.7], atol=1e-9)
    elif case == "diagonal":
        assert abs(got[0] - np.sqrt(3 * 0.2**2)) < 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closed_form_max_eigenvalue_matches_lapack(dtype):
    """The step size's largest eigenvalue of the 3x3 Grams in closed form
    against numpy's eigvalsh, with the degenerate cases (isotropic, a
    double eigenvalue, rank 1, zero): 1e-12 relative in f64, 1e-5 in f32."""
    rng = np.random.default_rng(4)
    M = rng.normal(size=(500, 16, 3)) * rng.uniform(0.01, 3, (500, 1, 1))
    G = np.concatenate([M.transpose(0, 2, 1) @ M, 2 * np.eye(3)[None],
                        np.diag([3.0, 1.0, 1.0])[None], np.outer([1, 2, 3], [1, 2, 3])[None],
                        np.zeros((1, 3, 3))])
    want = np.linalg.eigvalsh(G)[:, -1]
    got = tcm._sym3_max_eigenvalue(torch.as_tensor(G, dtype=dtype)).double().numpy()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 1e-3)


def test_simplex_projection_matches_numpy():
    """Each row projected onto the probability simplex: the sort-based
    closed form against a bisection on the threshold, with ties."""
    rng = np.random.default_rng(1)
    V = np.concatenate([rng.normal(size=(50, 7)) * 2, np.full((1, 7), 0.3),
                        np.array([[5.0, 5.0, -1, -1, -1, -1, -1]])])
    got = tcm._simplex_proj(T(V)).numpy()
    lo, hi = V.min(1) - 1, V.max(1)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        s = np.maximum(V - mid[:, None], 0).sum(1)
        lo, hi = np.where(s > 1, mid, lo), np.where(s > 1, hi, mid)
    np.testing.assert_allclose(got, np.maximum(V - hi[:, None], 0), atol=1e-12)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-12)


def _trees(tmp_path, urdf_text, stl=False):
    p = tmp_path / "robot.urdf"
    p.write_text(urdf_text)
    if stl:
        soup = np.concatenate([
            _box_soup((0, 0, -0.05), (0.5, 0.5, 0.05)),
            _box_soup((+0.4, 0, 0.2), (0.1, 0.5, 0.2)),
            _box_soup((-0.4, 0, 0.2), (0.1, 0.5, 0.2)),
        ])
        _write_stl_soup(tmp_path / "uchannel.stl", soup)
    return jax_load_urdf(str(p)), load_urdf(str(p))


@pytest.mark.parametrize("urdf", ["plates", "channel", "h30"])
def test_link_vertices_and_triangles_equal_jax(tmp_path, urdf):
    if urdf == "h30":
        jt, tt = jax_load_urdf(H30_URDF), load_urdf(H30_URDF)
    else:
        jt, tt = _trees(tmp_path, PLATES_URDF if urdf == "plates" else CHANNEL_URDF,
                        stl=urdf == "channel")
    for name in tt.link_names:
        for mode, full in (("box", False), ("convex", False), ("convex", True)):
            a = jcm.link_vertices(jt, name, mode=mode, full=full)
            b = tcm.link_vertices(tt, name, mode=mode, full=full)
            assert (a is None) == (b is None), (name, mode)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        a, b = jcm.link_triangles(jt, name), tcm.link_triangles(tt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    R = np.asarray(tcm._rpy_to_matrix([0.1, -0.2, 0.3]))
    for x, y in zip(jcm.box_triangles((1, 2, 3), (0.1, 0.2, 0.3), R),
                    tcm.box_triangles((1, 2, 3), (0.1, 0.2, 0.3), R)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", ["stl", "dae", "dae_polylist", "dae_y_up"])
def test_load_mesh_triangles_equal_jax(tmp_path, fmt):
    if fmt == "stl":
        p = tmp_path / "cube.stl"
        _write_stl(str(p), _CUBE_V, _CUBE_T)
    else:
        p = tmp_path / "cube.dae"
        p.write_text(_dae_text(polylist=fmt == "dae_polylist",
                               **(dict(up_axis="Y_UP", unit=0.01) if fmt == "dae_y_up" else {})))
    Vj, Tj = jgeo.load_mesh_triangles(str(p))
    Vt, Tt = tgeo.load_mesh_triangles(str(p))
    np.testing.assert_array_equal(Vj, Vt)
    np.testing.assert_array_equal(Tj, Tt)
    assert Tt.dtype == np.int32 and len(Tt) == 12
    if fmt == "stl":
        for x, y in zip(jgeo.load_stl_triangles(str(p)), tgeo.load_stl_triangles(str(p))):
            np.testing.assert_array_equal(x, y)


def _verifiers(jt, tt, cfg, world=None):
    """(JAX, port) verifiers of one configuration over one capsule model
    pair list (the port's on the CPU)."""
    jw, tw = (None, None) if world is None else world
    jcm_ = JaxCollisionModel(jt, JaxEngine(jt), dict(cfg, collisionMode="capsule"), world_tree=jw)
    tcm_ = CollisionModel(tt, DynamicsEngine(tt), dict(cfg, collisionMode="capsule"), world_tree=tw)
    assert jcm_.pair_names == tcm_.pair_names
    return (jcm.MeshCollisionVerifier(jt, JaxEngine(jt), cfg, jcm_, world_tree=jw),
            tcm.MeshCollisionVerifier(tt, DynamicsEngine(tt), cfg, tcm_, world_tree=tw,
                                      device="cpu"))


def _assert_verifiers_agree(jv, tv, Q, **kw):
    assert jv.pair_names == tv.pair_names
    np.testing.assert_array_equal(jv.margins, tv.margins)
    Dj = jv.min_clearances(Q, per_sample=True, **kw)
    Dt = tv.min_clearances(Q, per_sample=True, **kw)
    assert Dt.dtype == np.float32 and Dt.shape == Dj.shape
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=TOL_VERIFIER)
    # a sample's clearance does not depend on the chunk it went through
    np.testing.assert_array_equal(tv.min_clearances(Q, per_sample=True, chunk=3, **kw), Dt)
    np.testing.assert_array_equal(tv.min_clearances(Q, **kw), Dt.min(axis=0))
    okj, badj = jv.verify(Q, **kw)
    okt, badt = tv.verify(Q, **kw)
    assert okj == okt
    assert [p for p, _ in badj] == [p for p, _ in badt]
    np.testing.assert_allclose([d for _, d in badt], [d for _, d in badj], atol=TOL_VERIFIER)
    return okt, badt


@pytest.mark.parametrize("mode", ["convex", "box"])
def test_verifier_plates_matches_jax(tmp_path, mode):
    """The overlapping plates (rejected) and the 45-degree pose that
    clears them (accepted: a plate's link-frame box is the plate), plus
    random poses."""
    jt, tt = _trees(tmp_path, PLATES_URDF)
    jv, tv = _verifiers(jt, tt, dict(BASE_CFG, collisionMode=mode))
    assert ("base_plate", "plate_b") in tv.pair_names
    ok, bad = _assert_verifiers_agree(jv, tv, np.zeros((1, 2)))
    assert not ok and dict(bad)[("base_plate", "plate_b")] <= 1e-3
    ok, _ = _assert_verifiers_agree(jv, tv, np.array([[0.0, np.pi / 4]]))
    assert ok
    Q = np.random.default_rng(0).uniform(-3, 3, (7, 2))
    _assert_verifiers_agree(jv, tv, Q, step=2)


@pytest.mark.parametrize("mode", ["convex", "full", "full_links"])
def test_verifier_channel_matches_jax(tmp_path, mode):
    """The U-channel with the bar in its cavity: the hull tier rejects,
    the triangle-exact tier (collisionMode full, or the channel listed in
    fullMeshLinks) accepts; the bar in the wall is rejected by all."""
    jt, tt = _trees(tmp_path, CHANNEL_URDF, stl=True)
    cfg = dict(BASE_CFG, collisionMode="convex")
    if mode == "full":
        cfg["collisionMode"] = "full"
    elif mode == "full_links":
        cfg["fullMeshLinks"] = ["channel"]
    jv, tv = _verifiers(jt, tt, cfg)
    assert sorted(tv._native) == sorted(jv._native)
    assert bool(tv._native) == (mode != "convex")
    ok, bad = _assert_verifiers_agree(jv, tv, np.array([[0.0, np.pi / 2]]))
    assert ok == (mode != "convex")
    ok, bad = _assert_verifiers_agree(jv, tv, np.array([[0.0, 0.0], [0.0, np.pi / 2]]))
    assert not ok and dict(bad)[("channel", "bar")] <= 1e-3


def test_verifier_full_rejects_containment_with_world(tmp_path):
    """The bar inside the cavity and inside a world cage: a world pair
    with base poses (rotation and position), containment flagged by the
    native tier in both packages."""
    jt, tt = _trees(tmp_path, CHANNEL_URDF, stl=True)
    wp = tmp_path / "room.urdf"
    wp.write_text(WORLD_URDF)
    world = (jax_load_urdf(str(wp)), load_urdf(str(wp)))
    jv, tv = _verifiers(jt, tt, dict(BASE_CFG, collisionMode="full"), world=world)
    assert ("bar", "cage") in tv.world_pairs
    ok, bad = _assert_verifiers_agree(jv, tv, np.array([[0.0, np.pi / 2]]))
    assert not ok and ("bar", "cage") in [p for p, _ in bad]
    rng = np.random.default_rng(2)
    Q = rng.uniform(-3, 3, (5, 2))
    from flobaroid_tpu_torch.dynamics.spatial import rpy_to_rot_np

    BR = rpy_to_rot_np(0.2 * rng.normal(size=(5, 3)))
    _assert_verifiers_agree(jv, tv, Q, base_rot=BR, base_pos=rng.normal(size=(5, 3)))
    _assert_verifiers_agree(jv, tv, Q, base_rot=BR)  # no position: the base at the origin


def test_verifier_without_pairs_has_its_attributes(tmp_path):
    jt, tt = _trees(tmp_path, PLATES_URDF)
    _, tv = _verifiers(jt, tt, dict(BASE_CFG, collisionMode="convex",
                                    ignoreLinkPairsForCollision=[["base_plate", "plate_b"]]))
    assert tv.num_pairs == 0 and tv._native == {} and tv._full_links == set()
    assert tv.verify(np.zeros((3, 2))) == (True, [])
    assert tv.min_clearances(np.zeros((3, 2))).shape == (0,)


def test_native_distances_match_jax_binding():
    """The library the port builds into build/flobaroid_tpu_torch/ gives
    the JAX binding's distances, containment and point queries."""
    if not (tnm.available() and jnm.available()):
        pytest.skip("no C++ compiler for the native mesh-distance library")
    assert tnm._LIB._name == str(_build.BUILD_DIR / "libmeshdist.so")
    va, ta = tcm.box_triangles((0, 0, 0), (0.5, 0.5, 0.5), np.eye(3))
    vs, ts = tcm.box_triangles((0, 0, 0), (0.1, 0.1, 0.1), np.eye(3))
    rng = np.random.default_rng(0)
    v1, v2 = rng.normal(size=(60, 3)), rng.normal(size=(60, 3)) + [3.5, 0, 0]
    t1 = np.arange(60, dtype=np.int32).reshape(-1, 3)
    meshes = [(va, ta), (vs, ts), (v1, t1), (v2, t1)]
    J = [jnm.NativeMesh(v, t) for v, t in meshes]
    P = [tnm.NativeMesh(v, t) for v, t in meshes]
    c, s = np.cos(0.7), np.sin(0.7)
    poses = [np.eye(4), tnm.mesh_from_transform(None, [2, 0, 0]),
             tnm.mesh_from_transform(None, [0.5, 0, 0]),
             tnm.mesh_from_transform([[c, -s, 0], [s, c, 0], [0, 0, 1]], [2.0, 0.3, -0.1])]
    for i in range(len(meshes)):
        for j in range(len(meshes)):
            for Tb in poses:
                for brute in (False, True):
                    dj = jnm.distance(J[i], np.eye(4), J[j], Tb, brute=brute)
                    dt = tnm.distance(P[i], np.eye(4), P[j], Tb, brute=brute)
                    assert abs(dj - dt) <= 1e-12, (i, j, dj, dt)
                assert jnm.contained(J[i], np.eye(4), J[j], Tb) == \
                    tnm.contained(P[i], np.eye(4), P[j], Tb)
    assert tnm.contained(P[0], np.eye(4), P[1], np.eye(4))
    assert tnm.contains_point(P[0], np.eye(4), [0.0, 0.0, 0.0])
    assert not tnm.contains_point(P[0], np.eye(4), [0.9, 0.0, 0.0])
    with pytest.raises(ValueError):
        tnm.NativeMesh(va, ta + 100)
