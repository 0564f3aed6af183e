"""Plain rigid-body dynamics of a URDF robot: the benchmark's reference.

Written from the textbook Newton-Euler equations, in float64, with
nothing taken from the program under test. It states the conventions
that the identification toolkit documents for its inputs and outputs:

* links in URDF document order, degrees of freedom in the document order
  of the movable joints (revolute and continuous only here);
* ten standard parameters per link, [m, m*c, Ixx, Ixy, Ixz, Iyy, Iyz,
  Izz], with c and the inertia about the link origin in link axes;
* friction columns after the inertial ones: [Fc (n), Fv (n), offset (n)],
  Coulomb term Fc * tanh(v / threshold);
* floating base: rows [base force (3); base moment (3); joint torques],
  the base wrench in world axes about the base origin; base velocity and
  acceleration [linear; angular] in world axes, the linear part that of
  the base origin (classical acceleration); world_R_base = RPY(rpy)^T;
* a contact wrench [force; moment] acts at the origin of its link, in
  world axes; its generalized force is J^T w with J the frame Jacobian.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np
import torch

GRAVITY = (0.0, 0.0, -9.81)
MOVABLE = ("revolute", "continuous")


def rpy_matrix(rpy) -> np.ndarray:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = (float(a) for a in rpy)
    Rx = np.array([[1, 0, 0], [0, math.cos(r), -math.sin(r)], [0, math.sin(r), math.cos(r)]])
    Ry = np.array([[math.cos(p), 0, math.sin(p)], [0, 1, 0], [-math.sin(p), 0, math.cos(p)]])
    Rz = np.array([[math.cos(y), -math.sin(y), 0], [math.sin(y), math.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def rpy_matrix_t(rpy: torch.Tensor) -> torch.Tensor:
    """Batched Rz(yaw) @ Ry(pitch) @ Rx(roll) of (..., 3) angles."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = mat([[one, zero, zero], [zero, c[..., 0], -s[..., 0]], [zero, s[..., 0], c[..., 0]]])
    Ry = mat([[c[..., 1], zero, s[..., 1]], [zero, one, zero], [-s[..., 1], zero, c[..., 1]]])
    Rz = mat([[c[..., 2], -s[..., 2], zero], [s[..., 2], c[..., 2], zero], [zero, zero, one]])
    return Rz @ Ry @ Rx


def _floats(text, default):
    return np.array([float(v) for v in text.split()]) if text else np.array(default, float)


@dataclass
class Robot:
    link_names: list
    parent: np.ndarray  # (L,) parent link, -1 at the root
    joint_R: np.ndarray  # (L, 3, 3) joint origin rotation in the parent's axes
    joint_p: np.ndarray  # (L, 3) joint origin in the parent's axes
    axis: np.ndarray  # (L, 3) unit axis in the child's axes (zero if fixed)
    dof_of_link: np.ndarray  # (L,) dof index moving the link, -1 if fixed
    dof_names: list
    dof_link: np.ndarray  # (n,) child link of each dof
    lower: np.ndarray
    upper: np.ndarray
    velocity: np.ndarray
    friction: np.ndarray  # URDF <dynamics friction>, per dof
    damping: np.ndarray  # URDF <dynamics damping>, per dof
    params: np.ndarray  # (L, 10) standard parameters

    @property
    def num_links(self) -> int:
        return len(self.link_names)

    @property
    def num_dofs(self) -> int:
        return len(self.dof_names)

    def order(self) -> list:
        """Links with every parent before its children."""
        done, out = set(), []
        while len(out) < self.num_links:
            for i in range(self.num_links):
                if i not in done and (self.parent[i] < 0 or self.parent[i] in done):
                    done.add(i)
                    out.append(i)
        return out

    def subtree(self) -> np.ndarray:
        """(L, L) with [a, l] = 1 when link l lies in the subtree of link a."""
        S = np.eye(self.num_links)
        for l in range(self.num_links):
            a = self.parent[l]
            while a >= 0:
                S[a, l] = 1.0
                a = self.parent[a]
        return S


def load_urdf(path: str) -> Robot:
    root = ET.parse(path).getroot()
    links, params = [], []
    for el in root.findall("link"):
        links.append(el.get("name"))
        p = np.zeros(10)
        inertial = el.find("inertial")
        if inertial is not None:
            m = float(inertial.find("mass").get("value"))
            o = inertial.find("origin")
            c = _floats(o.get("xyz") if o is not None else None, [0, 0, 0])
            R = rpy_matrix(_floats(o.get("rpy") if o is not None else None, [0, 0, 0]))
            i = inertial.find("inertia")
            k = {a: float(i.get(a, 0)) for a in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")}
            Ic = np.array([[k["ixx"], k["ixy"], k["ixz"]],
                           [k["ixy"], k["iyy"], k["iyz"]],
                           [k["ixz"], k["iyz"], k["izz"]]])
            Io = R @ Ic @ R.T + m * (c @ c * np.eye(3) - np.outer(c, c))  # parallel axes
            p = np.array([m, *(m * c), Io[0, 0], Io[0, 1], Io[0, 2], Io[1, 1], Io[1, 2], Io[2, 2]])
        params.append(p)
    index = {n: i for i, n in enumerate(links)}
    L = len(links)
    parent = np.full(L, -1)
    joint_R = np.tile(np.eye(3), (L, 1, 1))
    joint_p = np.zeros((L, 3))
    axis = np.zeros((L, 3))
    dof_of_link = np.full(L, -1)
    dofs, lim, dyn = [], [], []
    for el in root.findall("joint"):
        jtype = el.get("type")
        if jtype not in MOVABLE + ("fixed",):
            raise ValueError(f"joint type {jtype!r} is not modelled by the reference")
        if el.find("mimic") is not None:
            raise ValueError("mimic joints are not modelled by the reference")
        child = index[el.find("child").get("link")]
        parent[child] = index[el.find("parent").get("link")]
        o = el.find("origin")
        joint_p[child] = _floats(o.get("xyz") if o is not None else None, [0, 0, 0])
        joint_R[child] = rpy_matrix(_floats(o.get("rpy") if o is not None else None, [0, 0, 0]))
        if jtype in MOVABLE:
            a = el.find("axis")
            ax = _floats(a.get("xyz") if a is not None else None, [1, 0, 0])
            axis[child] = ax / np.linalg.norm(ax)
            dof_of_link[child] = len(dofs)
            dofs.append((el.get("name"), child))
            li = el.find("limit")
            lo = float(li.get("lower", -math.pi)) if li is not None else -math.pi
            hi = float(li.get("upper", math.pi)) if li is not None else math.pi
            if jtype == "continuous":
                lo, hi = -math.pi, math.pi
            vel = float(li.get("velocity", np.inf)) if li is not None else np.inf
            lim.append((lo, hi, vel))
            d = el.find("dynamics")
            dyn.append((float(d.get("friction", 0)), float(d.get("damping", 0)))
                       if d is not None else (0.0, 0.0))
    lim, dyn = np.array(lim), np.array(dyn)
    return Robot(links, parent, joint_R, joint_p, axis, dof_of_link,
                 [n for n, _ in dofs], np.array([c for _, c in dofs]),
                 lim[:, 0], lim[:, 1], lim[:, 2], dyn[:, 0], dyn[:, 1], np.array(params))


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _rodrigues(axis, q):
    """Rotation by angle q (N,) about the fixed unit axis (3,)."""
    K = _skew(axis.expand(q.shape[0], 3))
    s, c = torch.sin(q)[:, None, None], torch.cos(q)[:, None, None]
    return torch.eye(3, dtype=q.dtype, device=q.device) + s * K + (1 - c) * (K @ K)


def _ivec_map(w):
    """(N, 3, 6) matrix M(w) with M(w) @ [Ixx, Ixy, Ixz, Iyy, Iyz, Izz] = I @ w."""
    x, y, z = w[:, 0], w[:, 1], w[:, 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([x, y, z, o, o, o], -1),
                        torch.stack([o, x, o, y, z, o], -1),
                        torch.stack([o, o, x, o, y, z], -1)], -2)


def kinematics(robot: Robot, Q, V, A, base=None):
    """World poses and motion of every link, by recursion from the root.

    Q, V, A: (N, n) tensors. base: None (fixed base) or (R (N, 3, 3),
    vel (N, 6), acc (N, 6)) of the floating base. Returns per link lists
    of R (N, 3, 3), p (N, 3) (origin relative to the base origin), w, v,
    wd, a (N, 3) in world axes; a is the classical acceleration of the
    link origin with gravity folded in (a - g), so that gravity enters
    every link's inertial wrench."""
    N = Q.shape[0]
    kw = dict(dtype=Q.dtype, device=Q.device)
    g = torch.tensor(GRAVITY, **kw)
    L = robot.num_links
    R, p, w, v, wd, a = ([None] * L for _ in range(6))
    for i in robot.order():
        pa = robot.parent[i]
        if pa < 0:
            if base is None:
                R[i] = torch.eye(3, **kw).expand(N, 3, 3)
                w[i] = v[i] = wd[i] = torch.zeros((N, 3), **kw)
                a[i] = -g.expand(N, 3)
            else:
                R[i], vel, acc = base
                v[i], w[i] = vel[:, :3], vel[:, 3:]
                wd[i], a[i] = acc[:, 3:], acc[:, :3] - g
            p[i] = torch.zeros((N, 3), **kw)
            continue
        R0 = torch.as_tensor(robot.joint_R[i], **kw)
        r = R[pa] @ torch.as_tensor(robot.joint_p[i], **kw)
        p[i] = p[pa] + r
        w[i], wd[i] = w[pa], wd[pa]
        v[i] = v[pa] + torch.linalg.cross(w[pa], r)
        a[i] = a[pa] + torch.linalg.cross(wd[pa], r) + torch.linalg.cross(
            w[pa], torch.linalg.cross(w[pa], r))
        d = robot.dof_of_link[i]
        if d < 0:
            R[i] = R[pa] @ R0
            continue
        ax = torch.as_tensor(robot.axis[i], **kw)
        R[i] = R[pa] @ R0 @ _rodrigues(ax, Q[:, d])
        z = R[i] @ ax
        w[i] = w[pa] + z * V[:, d, None]
        wd[i] = wd[pa] + torch.linalg.cross(w[pa], z) * V[:, d, None] + z * A[:, d, None]
    return R, p, w, v, wd, a


def link_wrench_columns(R, w, wd, a):
    """Linear maps from one link's ten parameters to its inertial wrench in
    world axes about the link origin: force f (N, 3, 10), moment n (N, 3, 10).
    In link axes: f = m a + (S(wd) + S(w)^2) h, n = I wd + w x I w - a x h."""
    Rt = R.transpose(-1, -2)
    wb, wdb, ab = ((Rt @ x[..., None])[..., 0] for x in (w, wd, a))
    N = wb.shape[0]
    zeros = torch.zeros((N, 3, 6), dtype=wb.dtype, device=wb.device)
    Sw = _skew(wb)
    f = torch.cat([ab[..., None], _skew(wdb) + Sw @ Sw, zeros], dim=-1)
    n = torch.cat([torch.zeros_like(ab)[..., None], -_skew(ab),
                   _ivec_map(wdb) + Sw @ _ivec_map(wb)], dim=-1)
    return R @ f, R @ n


def _motion_axes(robot: Robot, R, p):
    """Per dof the world axis z and the moment arm origin p of its joint."""
    kw = dict(dtype=R[0].dtype, device=R[0].device)
    z = [R[l] @ torch.as_tensor(robot.axis[l], **kw) for l in robot.dof_link]
    return z, [p[l] for l in robot.dof_link]


def regressor(robot: Robot, Q, V, A, base=None):
    """Inertial regressor Y (N, rows, 10 L): Y @ params is the inverse
    dynamics, rows [base force; base moment] (floating base) and then the
    joint torques."""
    R, p, w, v, wd, a = kinematics(robot, Q, V, A, base)
    L, n = robot.num_links, robot.num_dofs
    F, M = [], []  # world force and moment about the base origin, per link
    for i in range(L):
        f, m = link_wrench_columns(R[i], w[i], wd[i], a[i])
        F.append(f)
        M.append(m + torch.linalg.cross(p[i][..., None].expand_as(f), f, dim=-2))
    F, M = torch.stack(F, 1), torch.stack(M, 1)  # (N, L, 3, 10)
    z, pj = _motion_axes(robot, R, p)
    sub = torch.as_tensor(robot.subtree(), dtype=Q.dtype, device=Q.device)
    rows = []
    if base is not None:
        rows += [F.transpose(1, 2), M.transpose(1, 2)]  # (N, 3, L, 10) each
    for j in range(n):
        # torque about joint j's axis of the wrenches of its subtree
        arm = M - torch.linalg.cross(pj[j][:, None, :, None].expand_as(F), F, dim=-2)
        t = torch.einsum("nd,nldc->nlc", z[j], arm) * sub[robot.dof_link[j]][None, :, None]
        rows.append(t[:, None])
    Y = torch.cat(rows, dim=1)
    return Y.reshape(Q.shape[0], Y.shape[1], L * 10)


def friction_columns(V, threshold: float, rows_before: int):
    """Friction regressor columns (N, rows_before + n, 3 n): Fc tanh(v/th),
    Fv v and a torque offset on each joint row; zero in the base rows."""
    N, n = V.shape
    eye = torch.eye(n, dtype=V.dtype, device=V.device)
    cols = torch.cat([torch.tanh(V / threshold)[:, :, None] * eye,
                      V[:, :, None] * eye, eye.expand(N, n, n)], dim=2)
    return torch.cat([cols.new_zeros((N, rows_before, 3 * n)), cols], dim=1)


def contact_torques(robot: Robot, link: int, Q, base_R, wrench):
    """Generalized force J^T w (N, 6 + n) of a wrench [force; moment]
    (N, 6) at the origin of `link`, world axes, on a floating base."""
    zeros = torch.zeros_like(Q)
    R, p, *_ = kinematics(robot, Q, zeros, zeros,
                          (base_R, Q.new_zeros(Q.shape[0], 6), Q.new_zeros(Q.shape[0], 6)))
    f, m = wrench[:, :3], wrench[:, 3:]
    m0 = m + torch.linalg.cross(p[link], f)  # moment about the base origin
    z, pj = _motion_axes(robot, R, p)
    sub = robot.subtree()
    joint = [(sub[robot.dof_link[j], link] * (z[j] * (m0 - torch.linalg.cross(pj[j], f))).sum(-1))
             for j in range(robot.num_dofs)]
    return torch.cat([f, m0, torch.stack(joint, dim=1)], dim=1)


def spatial_inertia(p10: np.ndarray) -> np.ndarray:
    """6x6 spatial inertia about the link origin, [[I, S(h)], [S(h)^T, m E]]."""
    m, h, v = p10[0], p10[1:4], p10[4:10]
    Io = np.array([[v[0], v[1], v[2]], [v[1], v[3], v[4]], [v[2], v[4], v[5]]])
    Sh = np.array([[0, -h[2], h[1]], [h[2], 0, -h[0]], [-h[1], h[0], 0]])
    return np.block([[Io, Sh], [Sh.T, m * np.eye(3)]])
