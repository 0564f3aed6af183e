"""3D robot/trajectory visualization.

Counterpart of flobaroid_tpu/visualizer.py (reference pyglet/OpenGL
visualizer, visualizer.py:910-2153): renders the robot's geometry
(capsule / box collision model, STL visual meshes), world obstacles,
trajectory playback with optional floating-base pose,
collision-violation highlighting and torque-utilization display, with
matplotlib 3D (PNG snapshot or a self-contained animated HTML).

The kinematics run on the device: the forward kinematics and the
collision clearances of a whole trajectory are one batched call each
(`link_world_batch`, `violating_links_batch`) in f64; drawing is host
matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .dynamics.spatial import rpy_to_rot_np


def _capsule_points(p0, p1, r, n=10):
    """Wireframe points for a capsule segment."""
    p0, p1 = np.asarray(p0), np.asarray(p1)
    d = p1 - p0
    L = np.linalg.norm(d)
    if L < 1e-9:
        d = np.array([0, 0, 1.0])
    else:
        d = d / L
    # build orthonormal frame
    a = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, a)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    th = np.linspace(0, 2 * np.pi, n)
    circ = np.outer(np.cos(th), u) + np.outer(np.sin(th), v)
    return [p0 + r * circ, p1 + r * circ, np.array([p0 - r * d, p1 + r * d])]


def base_rotations(base_rpy) -> np.ndarray | None:
    """Per-sample base rotations used for drawing, (N, 3, 3), from the
    recorded base rpy (the transpose of the rpy rotation, as the JAX
    viewer applies it); None without a base."""
    if base_rpy is None:
        return None
    return np.swapaxes(rpy_to_rot_np(np.asarray(base_rpy, dtype=float)), -1, -2)


class Visualizer:
    def __init__(self, tree, engine, collision_model=None, world_tree=None,
                 urdf_path=None, mesh_base_dir="meshes", draw_meshes=True,
                 max_mesh_tris=600, tau_limits=None, collision_margin=0.0,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.tree = tree
        self.engine = engine
        self.cm = collision_model
        # torque-utilization display (reference visualizer torque arcs,
        # visualizer.py:910+) + extra clearance margin for the
        # collision-violation highlighting
        self.tau_limits = None if tau_limits is None else np.asarray(tau_limits, float)
        self.collision_margin = float(collision_margin)
        # visual meshes: decimated STL triangle soups per link drawn as
        # Poly3DCollections
        self.link_meshes: dict[int, list[tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
        if draw_meshes:
            from .models.geometry import load_mesh_vertices, resolve_mesh_path
            from .models.urdf import rpy_to_matrix

            for li, link in enumerate(tree.links):
                for vis in link.visuals or link.collisions:
                    g = vis.geometry
                    if g is None or g.kind != "mesh" or not g.filename:
                        continue
                    path = resolve_mesh_path(g.filename, urdf_path, mesh_base_dir)
                    if path is None:
                        continue
                    try:
                        verts = load_mesh_vertices(path)
                    except (OSError, ValueError):
                        continue
                    tris = verts.reshape(-1, 3, 3)
                    if len(tris) > max_mesh_tris:
                        keep = np.linspace(0, len(tris) - 1, max_mesh_tris).astype(int)
                        tris = tris[keep]
                    if g.scale is not None:
                        tris = tris * np.asarray(g.scale)
                    Rv = rpy_to_matrix(vis.origin_rpy)
                    self.link_meshes.setdefault(li, []).append(
                        (tris, Rv, np.asarray(vis.origin_xyz))
                    )

    def _t(self, a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype=float), dtype=torch.float64, device=self.device)

    def link_world_batch(self, Q, base_rot=None, base_pos=None):
        """World link orientations (F, L, 3, 3) and origins (F, L, 3) of
        the poses Q (F, n), with per-pose base rotations (F, 3, 3) and
        positions (F, 3) or None: one FK call on the device in f64."""
        R, p = self.engine.fk(self._t(Q))
        if base_rot is not None:
            Rb = self._t(base_rot)
            R = Rb[:, None] @ R
            p = (Rb[:, None] @ p[..., None])[..., 0]
        if base_pos is not None:
            p = p + self._t(base_pos)[:, None]
        return R.cpu().numpy(), p.cpu().numpy()

    def _link_world(self, q, base_rot=None, base_pos=None):
        """World link orientations (L, 3, 3) and origins (L, 3) of one pose."""
        R, p = self.link_world_batch(
            np.asarray(q, dtype=float)[None],
            None if base_rot is None else np.asarray(base_rot)[None],
            None if base_pos is None else np.asarray(base_pos)[None])
        return R[0], p[0]

    def clearances(self, Q, base_rot=None, base_pos=None) -> np.ndarray:
        """Clearance (F, n_pairs) of every collision pair at the poses Q
        (F, n): one batched call on the device in f64."""
        if self.cm is None or self.cm.num_pairs == 0:
            return np.zeros((len(Q), 0))
        return self.cm.distances(
            self._t(Q), self._t(base_rot), self._t(base_pos)).cpu().numpy()

    def violating_links_batch(self, Q, base_rot=None, base_pos=None) -> list[set]:
        """Per pose, the names of the links in a pair closer than the
        collision margin."""
        d = self.clearances(Q, base_rot, base_pos)
        out = []
        for row in d:
            bad = set()
            for i in np.nonzero(row < self.collision_margin)[0]:
                bad.update(self.cm.pair_names[i])
            out.append(bad)
        return out

    def draw_pose(self, ax, q, base_rot=None, base_pos=None, color="tab:blue", alpha=0.9,
                  pose=None, viol_links=None):
        """Draw one pose; `pose` (R, p) and `viol_links` come precomputed
        from the batched calls when a trajectory is drawn."""
        R, p = pose if pose is not None else self._link_world(q, base_rot, base_pos)
        # skeleton: joint-to-joint lines
        for i in range(self.tree.num_links):
            pa = int(self.tree.parent_link[i])
            if pa >= 0:
                ax.plot(*zip(p[pa], p[i]), color=color, lw=2, alpha=alpha)
        # visual meshes
        if self.link_meshes:
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection

            for li, meshes in self.link_meshes.items():
                for tris, Rv, tv in meshes:
                    world = np.einsum(
                        "ij,ntj->nti", R[li] @ Rv, tris
                    ) + (R[li] @ tv + p[li])
                    ax.add_collection3d(
                        Poly3DCollection(
                            world, facecolor=color, edgecolor="none", alpha=0.25
                        )
                    )
        # capsules
        if self.cm is not None:
            if viol_links is None:
                viol_links = self.violating_links_batch(
                    np.asarray(q, dtype=float)[None],
                    None if base_rot is None else np.asarray(base_rot)[None],
                    None if base_pos is None else np.asarray(base_pos)[None])[0]
            for name, cap in self.cm.capsules.items():
                li = self.tree.link_index[name]
                w0 = R[li] @ cap.p0 + p[li]
                w1 = R[li] @ cap.p1 + p[li]
                c = "red" if name in viol_links else color
                for pts in _capsule_points(w0, w1, cap.radius):
                    ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], color=c, lw=0.5, alpha=0.5)
            for name, (center, half, Rb) in getattr(self.cm, "world_boxes", {}).items():
                # box wireframe
                corners = np.array(
                    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
                ) * half
                cw = corners @ Rb.T + center
                edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7), (5, 1), (5, 4),
                         (5, 7), (6, 2), (6, 4), (6, 7)]
                for e0, e1 in edges:
                    ax.plot(*zip(cw[e0], cw[e1]), color="gray", lw=0.7, alpha=0.6)
        return ax

    def _setup_axes(self, ax, span=1.2):
        ax.set_xlim(-span, span)
        ax.set_ylim(-span, span)
        ax.set_zlim(-span * 0.4, span * 1.4)
        ax.set_box_aspect((1, 1, 0.9))
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_zlabel("z")

    def snapshot(self, q, filename="robot.png", base_rot=None, base_pos=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
        self._setup_axes(ax)
        self.draw_pose(ax, q, base_rot, base_pos)
        fig.savefig(filename, dpi=110)
        plt.close(fig)
        return filename

    def frames(self, Q, base_rpy=None, base_pos=None, step=10):
        """The played-back samples of a trajectory and, for each, its base
        rotation and position, its link poses and its violating links
        (one batched FK and one batched clearance call)."""
        idx = list(range(0, len(Q), max(1, int(step))))
        Qs = np.asarray(Q, dtype=float)[idx]
        br = None if base_rpy is None else base_rotations(np.asarray(base_rpy)[idx])
        bp = None if base_pos is None else np.asarray(base_pos, dtype=float)[idx]
        R, p = self.link_world_batch(Qs, br, bp)
        viol = self.violating_links_batch(Qs, br, bp)
        return idx, Qs, br, bp, R, p, viol

    def animate(self, Q, filename="trajectory.html", base_rpy=None, base_pos=None,
                step=10, fps=10, torques=None):
        """Trajectory playback to a self-contained animated HTML
        (base64 PNG frames + JS scrubber)."""
        import base64
        import io

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        show_tau = torques is not None and self.tau_limits is not None
        idx, Qs, br, bp, R, p, viol = self.frames(Q, base_rpy, base_pos, step)
        frames = []
        for f, k in enumerate(idx):
            if show_tau:
                fig = plt.figure(figsize=(7, 5))
                ax = fig.add_subplot(1, 2, 1, projection="3d")
                axb = fig.add_subplot(1, 2, 2)
            else:
                fig = plt.figure(figsize=(5, 5))
                ax = fig.add_subplot(projection="3d")
            self._setup_axes(ax)
            self.draw_pose(ax, Qs[f], None if br is None else br[f], None if bp is None else bp[f],
                           pose=(R[f], p[f]), viol_links=viol[f])
            if show_tau:
                tau_k = np.asarray(torques[k], float)[-len(self.tau_limits):]
                util = np.abs(tau_k) / np.maximum(self.tau_limits, 1e-9)
                colors = ["tab:red" if u > 1.0 else "tab:blue" for u in util]
                axb.barh(np.arange(len(util)), util, color=colors)
                axb.axvline(1.0, color="red", lw=1, ls="--")
                axb.set_xlim(0, 1.2)
                axb.set_yticks(np.arange(len(util)))
                axb.set_yticklabels(
                    self.tree.dof_names if len(self.tree.dof_names) == len(util) else
                    [str(i) for i in range(len(util))], fontsize=6)
                axb.set_xlabel("torque utilization")
            ax.set_title(f"sample {k}")
            buf = io.BytesIO()
            fig.savefig(buf, format="png", dpi=80)
            plt.close(fig)
            frames.append(base64.b64encode(buf.getvalue()).decode())

        html = [
            "<!DOCTYPE html><html><head><meta charset='utf-8'><title>trajectory</title></head><body>",
            "<img id='f' style='width:480px'/><br>",
            f"<input id='s' type='range' min='0' max='{len(frames) - 1}' value='0' style='width:480px'>",
            "<button onclick='play()'>play</button>",
            "<script>const frames=[",
            ",".join(f"'{f}'" for f in frames),
            "];const img=document.getElementById('f');const sl=document.getElementById('s');",
            "function show(i){img.src='data:image/png;base64,'+frames[i];}",
            "sl.oninput=()=>show(sl.value);show(0);",
            f"function play(){{let i=0;const t=setInterval(()=>{{show(i);sl.value=i;i++;if(i>=frames.length)clearInterval(t);}},{int(1000 / fps)});}}",
            "</script></body></html>",
        ]
        with open(filename, "w") as f:
            f.write("\n".join(html))
        return filename
