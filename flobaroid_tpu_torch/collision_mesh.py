"""Mesh-tier exact collision verification.

Counterpart of flobaroid_tpu/collision_mesh.py: the optimizer geometry
modes `collisionMode: box/convex/full` with per-link `fullMeshLinks`
overrides (reference excitation/optimizer.py:571-634), the FCL distance
queries (identification/collision.py:19-267) and the dense
re-verification of best trials (optimizer.py:1099-1132).

Capsules remain the differentiable optimizer geometry; this module is
the exact pass that verifies the winning candidate densely before it is
declared feasible. The distance between two convex vertex sets is the
simplex-constrained least squares

    min_{lam in S_a, mu in S_b}  || A^T lam - B^T mu ||

solved by a fixed-iteration accelerated projected-gradient method. In the
JAX package it is a `lax.scan` vmapped over pairs and samples; here it is
one Python loop of `iters` steps over a (samples, pairs) batch, so one
call of `min_clearances` covers every sample of a verification. The
vertex clouds and the link poses are float32 whatever the model computes
in, as in the JAX package; `polytope_distance` itself follows the dtype
of its inputs.

What differs from the JAX module: forward kinematics runs once per batch
(`DynamicsEngine.fk` over all samples, in float64) instead of per sample
under vmap, and the verifier's tensors live on an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native_meshdist as _nm
from .device import resolve_device
from .models.geometry import load_mesh_triangles, load_mesh_vertices, resolve_mesh_path
from .models.urdf import RobotTree
from .models.urdf import rpy_to_matrix as _rpy_to_matrix

_BOX_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])


# ----------------------------------------------------------------------
# vertex clouds per link (host, numpy)
# ----------------------------------------------------------------------
_SPHERE_DIRS = None


def _sphere_dirs():
    """42 near-uniform directions (subdivided icosahedron vertices)."""
    global _SPHERE_DIRS
    if _SPHERE_DIRS is None:
        phi = (1 + np.sqrt(5)) / 2
        v = []
        for a in (-1, 1):
            for b in (-phi, phi):
                v += [(0, a, b), (a, b, 0), (b, 0, a)]
        v = np.asarray(v, dtype=float)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        mids = []
        for i in range(len(v)):
            for j in range(i + 1, len(v)):
                # adjacent icosahedron vertices have dot 1/sqrt(5) ~ 0.447
                if np.dot(v[i], v[j]) > 0.3:
                    m = v[i] + v[j]
                    mids.append(m / np.linalg.norm(m))
        _SPHERE_DIRS = np.concatenate([v, np.asarray(mids)]) if mids else v
    return _SPHERE_DIRS


def link_vertices(
    tree: RobotTree,
    link_name: str,
    mode: str = "convex",
    full: bool = False,
    mesh_base_dir: str = "meshes",
    max_vertices: int = 256,
) -> np.ndarray | None:
    """Link-frame vertex cloud for one link's geometry.

    mode 'box': 8 AABB corners (reference optimizer.py 'box');
    mode 'convex'/'full': mesh vertices reduced to their convex hull
    ('full' keeps the raw vertex set up to max_vertices — reference
    fullMeshLinks semantics, still evaluated as its hull here).
    Primitives contribute exact corner/ring/sphere-direction points.
    Returns None when the link has no geometry."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if link.collisions else link.visuals
    pts = []
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = _rpy_to_matrix(el.origin_rpy)
        p0 = np.asarray(el.origin_xyz, dtype=float)
        if g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v = load_mesh_vertices(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
            pts.append(np.asarray(v) @ R.T + p0)
        else:
            v = _element_points(g)
            if v is not None:
                pts.append(v @ R.T + p0)
    if not pts:
        return None
    allp = np.concatenate(pts, axis=0)
    if mode == "box":
        lo, hi = allp.min(axis=0), allp.max(axis=0)
        return np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
        )
    if not full and len(allp) > 8:
        from scipy.spatial import ConvexHull, QhullError

        try:
            allp = allp[np.unique(ConvexHull(allp).vertices)]
        except (QhullError, ValueError):
            pass  # degenerate (coplanar etc.): keep raw points
    if len(allp) > max_vertices:
        # farthest-point downsample keeps the extremal shape
        keep = [int(np.argmax(np.linalg.norm(allp - allp.mean(0), axis=1)))]
        d = np.linalg.norm(allp - allp[keep[0]], axis=1)
        for _ in range(max_vertices - 1):
            k = int(np.argmax(d))
            keep.append(k)
            d = np.minimum(d, np.linalg.norm(allp - allp[k], axis=1))
        allp = allp[keep]
    return allp


def link_triangles(
    tree: RobotTree,
    link_name: str,
    mesh_base_dir: str = "meshes",
) -> tuple[np.ndarray, np.ndarray] | None:
    """(vertices, triangles) of a link's exact geometry in the link
    frame, for the native BVH narrowphase. Mesh geometries contribute
    their raw (non-convex) triangle soup; primitives are convex, so
    their hull triangulation is exact."""
    from scipy.spatial import ConvexHull, QhullError

    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if link.collisions else link.visuals
    all_v, all_t = [], []
    off = 0
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = _rpy_to_matrix(el.origin_rpy)
        p0 = np.asarray(el.origin_xyz, dtype=float)
        if g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v, t = load_mesh_triangles(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
        else:
            # primitive: exact convex triangulation of its point set
            v = _element_points(g)
            if v is None:
                continue
            try:
                t = np.asarray(ConvexHull(v).simplices, dtype=np.int32)
            except (QhullError, ValueError):
                continue
        all_v.append(v @ R.T + p0)
        all_t.append(np.asarray(t, dtype=np.int32) + off)
        off += len(v)
    if not all_v:
        return None
    return np.concatenate(all_v, axis=0), np.concatenate(all_t, axis=0)


def _element_points(g) -> np.ndarray | None:
    """Point set of one primitive geometry element (element frame)."""
    if g.kind == "box":
        return _BOX_SIGNS * (np.asarray(g.size) / 2.0)
    if g.kind in ("cylinder", "capsule"):
        r = float(g.radius or 0.0)
        h = float(g.length or 0.0) / 2.0
        ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        pts = [np.concatenate([ring, np.full((len(ring), 1), z)], axis=1)
               for z in (-h, h)]
        if g.kind == "capsule":
            pts.append(np.array([[0.0, 0.0, -(h + r)], [0.0, 0.0, h + r]]))
        return np.concatenate(pts, axis=0)
    if g.kind == "sphere":
        return _sphere_dirs() * float(g.radius or 0.0)
    return None


def box_triangles(center, half, R) -> tuple[np.ndarray, np.ndarray]:
    """12-triangle world box (for world-pair narrowphase)."""
    v = _BOX_SIGNS * np.asarray(half) @ np.asarray(R).T + np.asarray(center)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    t = []
    for a, b, c, d in quads:
        t += [(a, b, c), (a, c, d)]
    return v, np.asarray(t, dtype=np.int32)


# ----------------------------------------------------------------------
# batched convex distance (device)
# ----------------------------------------------------------------------
def _simplex_proj(v):
    """Euclidean projection of each row of v (..., V) onto the
    probability simplex."""
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    ind = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    # rho >= 1 for finite rows (u_0 - (u_0 - 1) = 1 > 0); the clamp keeps
    # the gather in range for a non-finite row
    rho = (u - css / ind > 0).sum(dim=-1, keepdim=True).clamp_min(1)
    theta = torch.gather(css, -1, rho - 1) / rho.to(v.dtype)
    return torch.clamp_min(v - theta, 0.0)


def _sym3_max_eigenvalue(G):
    """Largest eigenvalue of each symmetric 3x3 matrix of G (..., 3, 3),
    in closed form (the trigonometric solution of the characteristic
    cubic): elementwise, so any batch size. The batched eigensolver of
    cuSOLVER refuses batches of ~1e5 matrices (CUSOLVER_STATUS_INVALID_VALUE
    at 132 194 on an H100), and a verification sends millions."""
    a, b, c = G[..., 0, 0], G[..., 1, 1], G[..., 2, 2]
    d, e, f = G[..., 0, 1], G[..., 1, 2], G[..., 0, 2]
    q = (a + b + c) / 3.0
    aq, bq, cq = a - q, b - q, c - q
    p = torch.sqrt((aq * aq + bq * bq + cq * cq + 2.0 * (d * d + e * e + f * f)) / 6.0)
    det = aq * (bq * cq - e * e) - d * (d * cq - e * f) + f * (d * e - bq * f)
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    r = torch.clamp(det / (2.0 * safe_p**3), -1.0, 1.0)
    return torch.where(p > 0, q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0), q)


def polytope_distance(A, B, iters: int = 300):
    """Distance between conv(A) and conv(B) for a batch of problems:
    A (..., Va, 3), B (..., Vb, 3) -> (...,). Accelerated projected
    gradient on the product of simplices with a fixed iteration count;
    0 (to solver tolerance) when the hulls intersect."""
    # center per problem: keeps the Lipschitz constant at link scale
    c = 0.5 * (A.mean(dim=-2) + B.mean(dim=-2))
    A = A - c[..., None, :]
    B = B - c[..., None, :]
    M = torch.cat([A, -B], dim=-2)  # (..., Va+Vb, 3)
    # exact smax^2 from the 3x3 Gram
    L = (2.0 * _sym3_max_eigenvalue(M.transpose(-1, -2) @ M) + 1e-12)[..., None]
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    lam = torch.full(A.shape[:-1], 1.0 / A.shape[-2], dtype=A.dtype, device=A.device)
    mu = torch.full(B.shape[:-1], 1.0 / B.shape[-2], dtype=B.dtype, device=B.device)
    lam_p, mu_p = lam, mu
    for k in range(1, iters + 1):
        beta = (k - 1.0) / (k + 2.0)
        yl = lam + beta * (lam - lam_p)
        ym = mu + beta * (mu - mu_p)
        d = (At @ yl[..., None] - Bt @ ym[..., None])  # (..., 3, 1)
        gl = 2.0 * (A @ d)[..., 0]
        gm = -2.0 * (B @ d)[..., 0]
        lam_p, mu_p = lam, mu
        lam = _simplex_proj(yl - gl / L)
        mu = _simplex_proj(ym - gm / L)
    return torch.linalg.norm((At @ lam[..., None] - Bt @ mu[..., None])[..., 0], dim=-1)


class MeshCollisionVerifier:
    """Dense exact-geometry verification of a trajectory candidate.

    Pairs/margins are taken from an existing (capsule) CollisionModel so
    both tiers check the SAME pair set; only the geometry is upgraded
    to convex vertex hulls. The clearances are computed on `device`."""

    def __init__(self, tree, engine, config, capsule_model, world_tree=None, *, device="cuda"):
        self.tree = tree
        self.engine = engine
        self.config = config
        self.device = resolve_device(device)
        mode = str(config.get("collisionMode", "convex"))
        full_links = set(config.get("fullMeshLinks", []) or [])
        mesh_dir = str(config.get("meshBaseDir", "meshes"))

        verts: dict[str, np.ndarray] = {}
        for name in tree.link_names:
            v = link_vertices(
                tree, name,
                mode=("box" if mode == "box" else "convex"),
                full=(name in full_links or mode == "full"),
                mesh_base_dir=mesh_dir,
            )
            if v is not None:
                verts[name] = v

        self.self_pairs = [
            (a, b) for (a, b) in capsule_model.self_pairs if a in verts and b in verts
        ]
        self.world_pairs = [
            (rl, wl) for (rl, wl) in capsule_model.world_pairs if rl in verts
        ]
        self.pair_names = self.self_pairs + self.world_pairs
        wmargins = dict(zip(capsule_model.world_pairs, capsule_model.world_margins))
        self.margins = np.concatenate([
            np.zeros(len(self.self_pairs)),
            np.asarray([wmargins[p] for p in self.world_pairs], dtype=float),
        ]) if self.pair_names else np.zeros(0)

        # attributes verify()/min_clearances() read unconditionally must
        # exist even for a verifier with zero pairs
        self._native: dict[int, tuple] = {}
        self._full_links: set[str] = set()
        if not self.pair_names:
            return

        # pad every cloud to one V for stacking
        Vmax = max([len(verts[n]) for pair in self.self_pairs for n in pair]
                   + [len(verts[rl]) for rl, _ in self.world_pairs] + [0 if self.self_pairs else 8])

        def pad(v):
            if len(v) < Vmax:
                v = np.concatenate([v, np.repeat(v[:1], Vmax - len(v), axis=0)])
            return v

        def stack(names):
            return np.stack([pad(verts[n]) for n in names]) if names else np.zeros((0, Vmax, 3))

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float32,
                                   device=self.device)

        def idx(names):
            return torch.as_tensor([tree.link_index[n] for n in names], dtype=torch.int64,
                                   device=self.device)

        self._li_a = idx([a for a, _ in self.self_pairs])
        self._li_b = idx([b for _, b in self.self_pairs])
        self._Va = f32(stack([a for a, _ in self.self_pairs]))
        self._Vb = f32(stack([b for _, b in self.self_pairs]))
        # world boxes -> 8 world-frame corners
        self._wl = idx([rl for rl, _ in self.world_pairs])
        self._Vw_r = f32(stack([rl for rl, _ in self.world_pairs]))
        wb = []
        for _, wl in self.world_pairs:
            cen, half, R = capsule_model.world_boxes[wl]
            wb.append(_BOX_SIGNS * half @ R.T + cen)
        self._Vw_box = f32(np.asarray(wb).reshape(-1, 8, 3))
        self._margins = f32(self.margins)

        # triangle-exact native narrowphase for non-convex ("full") links:
        # the hull tier over-approximates them, so a near-contact hull
        # verdict is refined against the raw triangle BVH (the role FCL's
        # full-mesh mode plays in the reference, optimizer.py:571-634)
        self._full_links = {
            n for n in tree.link_names if n in full_links or mode == "full"
        }
        if self._full_links:
            if _nm.available():
                tri_cache: dict[str, object] = {}

                def nat(name):
                    if name not in tri_cache:
                        vt = link_triangles(tree, name, mesh_base_dir=mesh_dir)
                        tri_cache[name] = _nm.NativeMesh(*vt) if vt is not None else None
                    return tri_cache[name]

                for i, (a, b) in enumerate(self.self_pairs):
                    if a in self._full_links or b in self._full_links:
                        ma, mb = nat(a), nat(b)
                        if ma is not None and mb is not None:
                            self._native[i] = (ma, mb)
                for j, (rl, wl) in enumerate(self.world_pairs):
                    if rl in self._full_links:
                        mr = nat(rl)
                        if mr is not None:
                            cen, half, R = capsule_model.world_boxes[wl]
                            vw, tw = box_triangles(cen, half, R)
                            self._native[len(self.self_pairs) + j] = (
                                mr, _nm.NativeMesh(vw, tw)
                            )
            else:
                print(
                    "collision: native meshdist unavailable — full-mesh "
                    "links fall back to the (conservative) convex tier"
                )

    @property
    def num_pairs(self):
        return len(self.pair_names)

    def _world_fk(self, Q, BR, BP):
        """World link poses (S, L, 3, 3), (S, L, 3) in float64 on the
        verifier's device from host joint positions Q (S, n), base
        rotations BR (S, 3, 3) or None and positions BP (S, 3) or None."""
        def t(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, dtype=float), dtype=torch.float64, device=self.device)

        Q, BR, BP = t(Q), t(BR), t(BP)
        Rw, pw = self.engine.fk(Q)
        if BR is not None:
            Rw = BR[:, None] @ Rw
            pw = (BR[:, None] @ pw[..., None])[..., 0]
        if BP is not None:
            pw = pw + BP[:, None]
        return Rw, pw

    def _clearances(self, Q, BR, BP):
        """(S, n_pairs) float32 clearances of the samples Q (S, n)."""
        Rw, pw = self._world_fk(Q, BR, BP)
        Rw, pw = Rw.float(), pw.float()

        def place(li, V):  # link-frame clouds (P, V, 3) -> (S, P, V, 3)
            return (Rw[:, li] @ V.transpose(-1, -2)).transpose(-1, -2) + pw[:, li][:, :, None, :]

        parts = []
        if self.self_pairs:
            parts.append(polytope_distance(place(self._li_a, self._Va),
                                           place(self._li_b, self._Vb)))
        if self.world_pairs:
            Aw = place(self._wl, self._Vw_r)
            parts.append(polytope_distance(Aw, self._Vw_box.expand(Aw.shape[0], -1, -1, -1)))
        return torch.cat(parts, dim=1) - self._margins

    def min_clearances(self, Q, base_rot=None, base_pos=None, step=1,
                       chunk=None, per_sample=False):
        """(n_pairs,) minimum exact clearance over the trajectory, or the
        full (n_samples, n_pairs) clearance matrix with per_sample. The
        samples go through `chunk` at a time (all at once by default);
        each sample's clearance does not depend on the chunk. A base
        rotation without a base position places the base at the origin."""
        if self.num_pairs == 0:
            return np.zeros((0, 0)) if per_sample else np.zeros(0)
        Q = np.asarray(Q)[::step]
        BR = None if base_rot is None else np.asarray(base_rot)[::step]
        BP = None if base_rot is None or base_pos is None else np.asarray(base_pos)[::step]
        chunk = len(Q) if not chunk else int(chunk)
        out = []
        with torch.no_grad():
            for s in range(0, len(Q), chunk):
                sl = slice(s, s + chunk)
                D = self._clearances(Q[sl], None if BR is None else BR[sl],
                                     None if BP is None else BP[sl])
                out.append(D.cpu().numpy())
        D = np.concatenate(out, axis=0)
        return D if per_sample else D.min(axis=0)

    def _native_clearance(self, i, samples, Q, BR, BP) -> float:
        """Triangle-exact minimum clearance of pair i over `samples`
        (indices into the subsampled trajectory) via the native BVH."""
        ma, mb = self._native[i]
        tree = self.tree
        if i < len(self.self_pairs):
            a, b = self.self_pairs[i]
            la, lb = tree.link_index[a], tree.link_index[b]
        else:
            rl, _ = self.world_pairs[i - len(self.self_pairs)]
            la, lb = tree.link_index[rl], None
        with torch.no_grad():
            Rw, pw = self._world_fk(Q[samples], None if BR is None else BR[samples],
                                    None if BR is None or BP is None else BP[samples])
        Rw = Rw.cpu().numpy()
        pw = pw.cpu().numpy()
        best = np.inf
        margin = float(self.margins[i])
        for s in range(len(samples)):
            Ta = _nm.mesh_from_transform(Rw[s, la], pw[s, la])
            Tb = (
                np.eye(4) if lb is None
                else _nm.mesh_from_transform(Rw[s, lb], pw[s, lb])
            )
            d = _nm.distance(ma, Ta, mb, Tb)
            if d > 0 and _nm.contained(ma, Ta, mb, Tb):
                # surface distance cannot see one body fully inside the
                # other (no surface crossing) — containment IS contact
                d = 0.0
            best = min(best, d - margin)
            if best <= 0:
                break
        return best

    def verify(self, Q, base_rot=None, base_pos=None, step=1, tol=1e-3):
        """(ok, violations): violations = [(pair, clearance), ...].

        A convex DISTANCE saturates at 0 under penetration, so contact
        is flagged at clearance < +tol (the reference separately
        confirms 0-distance BVH results with a collide() call,
        collision.py:19-267 — here the positive threshold plays that
        role). Pairs involving "full"-mode links re-check their
        near-contact samples against the raw-triangle BVH: the hull
        distance lower-bounds the mesh distance, so samples the hull
        already clears need no refinement."""
        want_refine = bool(self._native)
        D = self.min_clearances(
            Q, base_rot=base_rot, base_pos=base_pos, step=step,
            per_sample=want_refine,
        )
        mins = D.min(axis=0) if want_refine else D
        Qs = np.asarray(Q)[::step]
        BRs = None if base_rot is None else np.asarray(base_rot)[::step]
        BPs = None if base_pos is None else np.asarray(base_pos)[::step]
        bad = []
        for i in range(self.num_pairs):
            if mins[i] >= tol:
                continue
            if want_refine and i in self._native:
                samples = np.where(D[:, i] < tol)[0]
                refined = self._native_clearance(i, samples, Qs, BRs, BPs)
                if refined >= tol:
                    continue
                bad.append((self.pair_names[i], float(refined)))
            else:
                bad.append((self.pair_names[i], float(mins[i])))
        return (len(bad) == 0), bad
