"""Collision model: capsule primitives with differentiable distances.

Counterpart of flobaroid_tpu/collision.py (reference
excitation/capsule.py: capsule fitting from URDF cylinder / sphere / box
/ mesh geometry, closed-form segment-segment distance; reference
identification/collision.py: CollisionChecker with margins, robot-self
and robot-world queries).

Capsules are the primary representation: the segment-segment distance is
a small closed-form expression, written here over leading batch axes, so
a whole population of trajectories times all collision pairs is one
batched call and `torch.autograd` provides the collision gradients. The
clamps and selections are the JAX module's, written with ops whose
subgradients at ties agree with it (utils/tensor_ops.py). Mesh AABBs
seed the capsule fitting.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .models.geometry import link_bounding_box, load_mesh_vertices, resolve_mesh_path
from .models.urdf import RobotTree, rpy_to_matrix
from .utils.tensor_ops import clip, const, maximum, minimum


@dataclass
class Capsule:
    p0: np.ndarray  # segment start (link frame)
    p1: np.ndarray  # segment end
    radius: float


def fit_capsule(
    tree: RobotTree,
    link_name: str,
    use_collision: bool = True,
    scale: float = 1.0,
    mesh_base_dir: str = "meshes",
) -> Capsule | None:
    """Fit one capsule covering all of a link's geometry
    (reference capsule.py:30-275: per-primitive capsules merged with an
    inward radius pull). Strategy: collect primitive-aligned segments +
    radii, then merge along the dominant extent of their union."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if use_collision and link.collisions else link.visuals
    segs: list[tuple[np.ndarray, np.ndarray, float]] = []
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = rpy_to_matrix(el.origin_rpy)
        p = el.origin_xyz
        if g.kind == "cylinder" or g.kind == "capsule":
            h = (g.length or 0.0) / 2.0
            a = p + R @ np.array([0, 0, -h])
            b = p + R @ np.array([0, 0, h])
            segs.append((a, b, float(g.radius or 0.0)))
        elif g.kind == "sphere":
            segs.append((p, p.copy(), float(g.radius or 0.0)))
        elif g.kind == "box":
            size = np.asarray(g.size)
            ax = int(np.argmax(size))
            h = size[ax] / 2.0
            d = np.zeros(3)
            d[ax] = 1.0
            others = np.delete(size, ax)
            r = float(np.linalg.norm(others) / 2.0) * 0.9  # inward pull
            segs.append((p + R @ (-h * d), p + R @ (h * d), r))
        elif g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v = load_mesh_vertices(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
            v = v @ R.T + p
            lo, hi = v.min(axis=0), v.max(axis=0)
            size = hi - lo
            c = (lo + hi) / 2.0
            ax = int(np.argmax(size))
            h = size[ax] / 2.0
            d = np.zeros(3)
            d[ax] = 1.0
            others = np.delete(size, ax)
            r = float(np.linalg.norm(others) / 2.0) * 0.85
            segs.append((c - h * d, c + h * d, r))
    if not segs:
        return None
    if len(segs) == 1:
        a, b, r = segs[0]
        return Capsule(a * scale, b * scale, r * scale)
    # merge: endpoints = farthest pair among all segment endpoints;
    # radius covers every primitive's axis w.r.t. the merged axis
    pts = np.array([q for s in segs for q in (s[0], s[1])])
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    i, j = np.unravel_index(np.argmax(d2), d2.shape)
    a, b = pts[i], pts[j]
    ab = b - a
    denom = max(float(ab @ ab), 1e-12)
    r_need = 0.0
    for s0, s1, r in segs:
        for q in (s0, s1):
            t = np.clip((q - a) @ ab / denom, 0, 1)
            dist = np.linalg.norm(q - (a + t * ab))
            r_need = max(r_need, dist * 0.8 + r)  # inward pull on offset
    return Capsule(a * scale, b * scale, r_need * scale)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def point_box_distance(p, center, half, R=None):
    """Signed distance from points (..., 3) to oriented boxes (negative
    inside). R: box orientation (world_R_box), half: half extents."""
    d = p - center
    if R is not None:
        d = (R.transpose(-1, -2) @ d[..., None])[..., 0]
    q = torch.abs(d) - half
    outside = torch.sqrt((maximum(q, 0.0) ** 2).sum(dim=-1) + 1e-12)
    inside = minimum(q.amax(dim=-1), 0.0)
    return outside + inside


def segment_box_distance(p0, p1, center, half, R=None, n_samples: int = 9):
    """Min distance from segments to oriented boxes, via point samples
    along the segment (differentiable; exact for boxes much larger than
    the sample spacing — the world-geometry case)."""
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=p0.dtype, device=p0.device)
    pts = p0[..., None, :] + ts[:, None] * (p1 - p0)[..., None, :]  # (..., S, 3)
    ds = point_box_distance(
        pts, center[..., None, :], half[..., None, :], None if R is None else R[..., None, :, :])
    return ds.amin(dim=-1)


def segment_segment_distance(p1, q1, p2, q2, eps=1e-12):
    """Closed-form minimum distance between segments [p1,q1] and [p2,q2]
    (Ericson, Real-Time Collision Detection; reference capsule.py:283-349).
    Branchless, over any leading batch axes (last axis 3)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    zero = const(0.0, a)

    # general case (clamped afterwards); guard degenerate segments
    s_num = torch.where(denom > eps, (b * f - c * e), zero)
    s = clip(s_num / maximum(denom, eps), 0.0, 1.0)
    t = torch.where(e > eps, (b * s + f) / maximum(e, eps), zero)
    # re-clamp s for clamped t
    t_cl = clip(t, 0.0, 1.0)
    s = torch.where(t != t_cl, clip((t_cl * b - c) / maximum(a, eps), 0.0, 1.0), s)
    t = t_cl
    # degenerate: point-segment / point-point. When segment 2 is a
    # point (zero-length capsule from a sphere geometry), the closest
    # point on segment 1 is s = clamp(-c/a) (Ericson 5.1.9) — the
    # general-case formula collapses to s = 0 there (denom = 0)
    s = torch.where((e <= eps) & (a > eps), clip(-c / maximum(a, eps), 0.0, 1.0), s)
    s = torch.where(a <= eps, zero, s)
    t = torch.where(e <= eps, zero, t)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    return torch.sqrt(((c1 - c2) ** 2).sum(dim=-1) + eps)


class CollisionModel:
    """Capsule collision pairs with batched differentiable distances
    (computed on the device of the joint positions they are given).

    Pair construction mirrors the reference
    (trajectoryOptimizer._buildCollisionPairs :630-707): all link pairs
    with geometry, minus ignore lists/pairs, minus kinematic-tree
    neighbors (fixed-joint chains count as one body), minus pairs
    within `maxKinematicDistance` joints, plus robot-world pairs with
    per-pair margins."""

    def __init__(
        self,
        tree: RobotTree,
        engine,
        config: dict,
        world_tree: RobotTree | None = None,
    ):
        self.tree = tree
        self.engine = engine
        self.config = config
        scale = float(config.get("scaleCollisionHull", 1.0))

        ignore_links = set(config.get("ignoreLinksForCollision", []) or [])
        ignore_pairs = {
            tuple(sorted(p)) for p in (config.get("ignoreLinkPairsForCollision", []) or [])
        }
        # group-level ignores (reference trajectoryOptimizer.py:664-667):
        # every (a in groupA, b in groupB) pair is skipped
        for group_pair in config.get("ignoreCollisionBetweenGroups", []) or []:
            if len(group_pair) == 2:
                for ga in group_pair[0]:
                    for gb in group_pair[1]:
                        ignore_pairs.add(tuple(sorted((ga, gb))))

        # reference key scaleCapsuleRadius (capsule-mode radius scale,
        # excitation/optimizer.py:538): applied to the fitted radius
        rscale = float(config.get("scaleCapsuleRadius", 1.0))
        self.capsules: dict[str, Capsule] = {}
        for name in tree.link_names:
            if name in ignore_links:
                continue
            cap = fit_capsule(tree, name, scale=scale, mesh_base_dir=str(config.get("meshBaseDir", "meshes")))
            if cap is not None:
                if rscale != 1.0:
                    cap = Capsule(cap.p0, cap.p1, cap.radius * rscale)
                self.capsules[name] = cap

        # world geometry: oriented boxes fixed in world (capsules are a poor
        # fit for large flat obstacles like floors/tables), poses from the
        # world tree's FK at q=0
        self.world_boxes: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        if world_tree is not None:
            from .dynamics.engine import DynamicsEngine

            weng = DynamicsEngine(world_tree)
            Rw, pw = weng.fk(torch.zeros(world_tree.num_dofs, dtype=torch.float64))
            Rw, pw = Rw.numpy(), pw.numpy()
            for name in world_tree.link_names:
                if name in ignore_links:
                    continue
                link = world_tree.links[world_tree.link_index[name]]
                if not (link.visuals or link.collisions):
                    continue
                lo, hi = link_bounding_box(world_tree, name)
                li = world_tree.link_index[name]
                center_l = (lo + hi) / 2.0
                half = (hi - lo) / 2.0
                center_w = Rw[li] @ center_l + pw[li]
                self.world_boxes[name] = (center_w, half, Rw[li])

        # kinematic distance between links (fixed joints = distance 0)
        self._kin_dist = self._kinematic_distances()
        # reference key collisionMaxKinematicDistance
        # (trajectoryOptimizer.py:646); maxKinematicDistance is this
        # repo's earlier spelling, kept as a fallback
        ckd = config.get("collisionMaxKinematicDistance", None)
        max_kd = int(
            (ckd if ckd is not None else config.get("maxKinematicDistance", 0)) or 0
        )

        names = [n for n in tree.link_names if n in self.capsules]
        pairs = []
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                if tuple(sorted((a, b))) in ignore_pairs:
                    continue
                ia, ib = tree.link_index[a], tree.link_index[b]
                kd = self._kin_dist[ia, ib]
                if kd <= max(1, max_kd):
                    continue  # adjacent (or within the cap): never separates
                pairs.append((a, b))
        self.self_pairs = pairs

        margins_cfg = config.get("worldCollisionMargins", {}) or {}
        default_margin = float(config.get("worldCollisionDefaultMargin", 0.0))
        self.world_pairs = []
        self.world_margins = []
        for rl in names:
            for wl in self.world_boxes:
                if tuple(sorted((rl, wl))) in ignore_pairs:
                    continue
                self.world_pairs.append((rl, wl))
                self.world_margins.append(float(margins_cfg.get(wl, default_margin)))

        self.pair_names = self.self_pairs + self.world_pairs
        self.margins = np.concatenate(
            [np.zeros(len(self.self_pairs)), np.asarray(self.world_margins, dtype=float)]
        ) if self.pair_names else np.zeros(0)
        self._build_arrays()

    @property
    def num_pairs(self):
        return len(self.pair_names)

    def _kinematic_distances(self):
        """Joint-count distances between links; fixed joints contribute 0
        (fixed-joint-merged neighbors, reference helpers.py:762-798)."""
        tree = self.tree
        L = tree.num_links
        dist = np.full((L, L), 1000, dtype=int)
        import collections

        adj: dict[int, list[tuple[int, int]]] = collections.defaultdict(list)
        for i in range(L):
            pa = int(tree.parent_link[i])
            if pa < 0:
                continue
            j = tree.joints[tree.parent_joint[i]]
            w = 0 if j.jtype == "fixed" else 1
            adj[i].append((pa, w))
            adj[pa].append((i, w))
        for s in range(L):
            dq = collections.deque([(s, 0)])
            dist[s, s] = 0
            seen = {s}
            while dq:
                u, d = dq.popleft()
                for v, w in adj[u]:
                    if v not in seen or d + w < dist[s, v]:
                        seen.add(v)
                        if d + w < dist[s, v]:
                            dist[s, v] = d + w
                            dq.append((v, d + w))
        return dist

    def _build_arrays(self):
        tree = self.tree
        # robot-robot capsule pairs
        li_a, li_b = [], []
        p0a, p1a, ra = [], [], []
        p0b, p1b, rb = [], [], []
        for a, b in self.self_pairs:
            ca, cb = self.capsules[a], self.capsules[b]
            li_a.append(tree.link_index[a])
            li_b.append(tree.link_index[b])
            p0a.append(ca.p0); p1a.append(ca.p1); ra.append(ca.radius)
            p0b.append(cb.p0); p1b.append(cb.p1); rb.append(cb.radius)
        self._li_a = np.asarray(li_a, dtype=int)
        self._li_b = np.asarray(li_b, dtype=int)
        self._p0a = np.asarray(p0a).reshape(-1, 3); self._p1a = np.asarray(p1a).reshape(-1, 3)
        self._ra = np.asarray(ra)
        self._p0b = np.asarray(p0b).reshape(-1, 3); self._p1b = np.asarray(p1b).reshape(-1, 3)
        self._rb = np.asarray(rb)
        # robot-world capsule-box pairs
        wi, wp0, wp1, wr = [], [], [], []
        wc, wh, wR = [], [], []
        for rl, wl in self.world_pairs:
            ca = self.capsules[rl]
            c, h, R = self.world_boxes[wl]
            wi.append(tree.link_index[rl])
            wp0.append(ca.p0); wp1.append(ca.p1); wr.append(ca.radius)
            wc.append(c); wh.append(h); wR.append(R)
        self._wl = np.asarray(wi, dtype=int)
        self._wp0 = np.asarray(wp0).reshape(-1, 3); self._wp1 = np.asarray(wp1).reshape(-1, 3)
        self._wr = np.asarray(wr)
        self._wc = np.asarray(wc).reshape(-1, 3); self._wh = np.asarray(wh).reshape(-1, 3)
        self._wR = np.asarray(wR).reshape(-1, 3, 3)
        self._consts: dict = {}

    # ------------------------------------------------------------------
    def _c(self, dtype, device) -> dict:
        """Pair constants as tensors of one dtype on one device."""
        key = (dtype, str(device))
        c = self._consts.get(key)
        if c is None:
            def f(a):
                return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

            def i(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

            c = self._consts[key] = dict(
                li_a=i(self._li_a), li_b=i(self._li_b),
                p0a=f(self._p0a), p1a=f(self._p1a), ra=f(self._ra),
                p0b=f(self._p0b), p1b=f(self._p1b), rb=f(self._rb),
                wl=i(self._wl), wp0=f(self._wp0), wp1=f(self._wp1), wr=f(self._wr),
                wc=f(self._wc), wh=f(self._wh), wR=f(self._wR), margins=f(self.margins),
            )
        return c

    def distances(self, q, base_rot=None, base_pos=None):
        """Per-pair clearance (distance - radii - margin): (n_pairs,) at
        one pose q (n,), or (M, n_pairs) for poses (M, n) with base
        rotations (M, 3, 3) and positions (M, 3). Differentiable."""
        if q.ndim == 1:
            return self.distances(
                q[None], None if base_rot is None else base_rot[None],
                None if base_pos is None else base_pos[None])[0]
        if self.num_pairs == 0:
            return torch.zeros((q.shape[0], 0), dtype=q.dtype, device=q.device)
        c = self._c(q.dtype, q.device)
        Rw, pw = self.engine.fk(q)  # (M, L, 3, 3), (M, L, 3)
        if base_rot is not None:
            pw = (base_rot[:, None] @ pw[..., None])[..., 0]
            Rw = base_rot[:, None] @ Rw
        if base_pos is not None:
            pw = pw + base_pos[:, None]

        def to_world(li, P):  # link-frame points (pairs, 3) -> (M, pairs, 3)
            return (Rw[:, li] @ P[:, :, None])[..., 0] + pw[:, li]

        parts = []
        if len(self.self_pairs):
            d = segment_segment_distance(
                to_world(c["li_a"], c["p0a"]), to_world(c["li_a"], c["p1a"]),
                to_world(c["li_b"], c["p0b"]), to_world(c["li_b"], c["p1b"]))
            parts.append(d - c["ra"] - c["rb"])
        if len(self.world_pairs):
            d = segment_box_distance(
                to_world(c["wl"], c["wp0"]), to_world(c["wl"], c["wp1"]),
                c["wc"], c["wh"], c["wR"])
            parts.append(d - c["wr"])
        return torch.cat(parts, dim=-1) - c["margins"]

    def _trajectory_distances(self, Q, base_rot, base_pos):
        """Clearances (K, N, n_pairs) of trajectories Q (K, N, n) with
        their base poses (K, N, 3, 3) / (K, N, 3) or None."""
        K, N = Q.shape[:2]
        D = self.distances(
            Q.reshape(K * N, -1),
            None if base_rot is None else base_rot.reshape(K * N, 3, 3),
            None if base_pos is None else base_pos.reshape(K * N, 3))
        return D.reshape(K, N, -1)

    def min_distances_over_trajectory(self, Q, base_rot=None, base_pos=None, step=1):
        """(n_pairs,) minimum clearance over the trajectory Q (N, n), or
        (K, n_pairs) for a population (K, N, n); feeds the optimizer
        constraint g = -clearance <= 0."""
        if Q.ndim == 2:
            return self.min_distances_over_trajectory(
                Q[None], None if base_rot is None else base_rot[None],
                None if base_pos is None else base_pos[None], step)[0]
        D = self._trajectory_distances(
            Q[:, ::step], None if base_rot is None else base_rot[:, ::step],
            None if base_rot is None or base_pos is None else base_pos[:, ::step])
        return D.amin(dim=1)

    def constraint_fn(self, step: int = 3):
        """Returns extra_constraints_fn(Q) for TrajectoryObjective:
        g = -(min clearance per pair)."""

        def fn(Q):
            return -self.min_distances_over_trajectory(Q, step=step)

        return fn

    def trajectory_constraint_fn(
        self, step: int = 3, n_transition: int = 10, n_poses: int = 6
    ):
        """Full reference-parity collision constraint (reference
        trajectoryOptimizer.py:340-437): periodic samples are checked
        against their own (swung) base pose, and the minimum-jerk
        transition ramps from/to the zero posture are checked against
        representative base poses sampled from the periodic motion plus
        the extreme-swing pose (the suspension decays much slower than
        the ramp, so the base keeps swinging during transitions).

        Returns fn(Q, base_rot=None, base_pos=None) -> g with
        g = -(min clearance): (n_pairs,) for one trajectory Q (N, n),
        (K, n_pairs) for a population (K, N, n); differentiable."""

        def fn(Q, base_rot=None, base_pos=None):
            if Q.ndim == 2:
                return fn(Q[None], None if base_rot is None else base_rot[None],
                          None if base_pos is None else base_pos[None])[0]
            K, N = Q.shape[:2]
            kw = dict(dtype=Q.dtype, device=Q.device)
            if base_rot is not None and base_pos is None:
                base_pos = torch.zeros((K, N, 3), **kw)
            dmin = self.min_distances_over_trajectory(Q, base_rot, base_pos, step=step)

            if n_transition > 0:
                # quintic min-jerk time scaling: with a zero start
                # posture the ramp configurations are s_k * q_boundary
                taus = torch.arange(1, n_transition + 1, **kw) / (n_transition + 1)
                s = 10.0 * taus**3 - 15.0 * taus**4 + 6.0 * taus**5
                Qt = torch.cat(
                    [s[:, None] * Q[:, :1], s[:, None] * Q[:, -1:]], dim=1)  # (K, 2T, n)
                if base_rot is not None:
                    idx = torch.as_tensor(
                        np.linspace(0, N - 1, n_poses).astype(int), device=Q.device)
                    # extreme swing = largest rotation angle from identity
                    # (first maximum; the reference uses max |rpy| sum)
                    tr = base_rot.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
                    ang = torch.arccos(clip((tr - 1.0) / 2.0, -1.0, 1.0))
                    ext = torch.argmax(ang, dim=1)
                    k = torch.arange(K, device=Q.device)
                    PR = torch.cat([base_rot[:, idx], base_rot[k, ext][:, None]], dim=1)
                    PP = torch.cat([base_pos[:, idx], base_pos[k, ext][:, None]], dim=1)
                    T2, P = Qt.shape[1], PR.shape[1]
                    Dt = self._trajectory_distances(
                        Qt[:, :, None].expand(K, T2, P, Qt.shape[-1]).reshape(K, T2 * P, -1),
                        PR[:, None].expand(K, T2, P, 3, 3).reshape(K, T2 * P, 3, 3),
                        PP[:, None].expand(K, T2, P, 3).reshape(K, T2 * P, 3))
                else:
                    Dt = self._trajectory_distances(Qt, None, None)
                dmin = torch.minimum(dmin, Dt.amin(dim=1))
            return -dmin

        return fn

    # ------------------------------------------------------------------
    # CollisionChecker parity (reference identification/collision.py:19)
    # ------------------------------------------------------------------
    def check(self, q, base_rot=None, base_pos=None, margin=0.0):
        """Returns (ok, violations): pairs with clearance < margin (on
        the host, in f64)."""
        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a), dtype=torch.float64)

        d = self.distances(t(q), t(base_rot), t(base_pos)).numpy()
        viol = [
            (self.pair_names[i], float(d[i]))
            for i in range(self.num_pairs)
            if d[i] < margin
        ]
        return len(viol) == 0, viol

    def find_colliding_at_zero(self):
        """Pairs already overlapping at q=0 (reference
        capsule.find_colliding_links_capsule :508-579)."""
        nd = self.tree.num_dofs
        ok, viol = self.check(np.zeros(nd))
        return viol
