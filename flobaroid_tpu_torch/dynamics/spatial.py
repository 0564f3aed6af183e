"""Spatial (Plücker) algebra primitives on torch tensors.

Counterpart of flobaroid_tpu/dynamics/spatial.py. Motion vectors are
ordered [angular(3); linear(3)], force vectors [moment(3); force(3)].
Every helper broadcasts over leading batch dimensions and follows the
dtype/device of its input. `rpy_to_rot_np`/`rot_to_rpy_np` are the
numpy forms of the same convention for host-side staging and data
preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch


def skew(v):
    """Skew-symmetric cross-product matrix S(v) with S(v) @ w = v x w."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(S):
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def rpy_to_rot_np(rpy):
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) (URDF convention), numpy."""
    rpy = np.asarray(rpy, dtype=float)
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.stack(
        [
            np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            np.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rot_to_rpy_np(R):
    """Inverse of rpy_to_rot_np (pitch in [-pi/2, pi/2]) over any batch."""
    R = np.asarray(R, dtype=float)
    p = np.arctan2(-R[..., 2, 0], np.hypot(R[..., 0, 0], R[..., 1, 0]))
    y = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    r = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return np.stack([r, p, y], axis=-1)


def rpy_to_rot(rpy):
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) (URDF convention), torch."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_rpy(R):
    """Inverse of rpy_to_rot (pitch in [-pi/2, pi/2])."""
    p = torch.atan2(-R[..., 2, 0], torch.hypot(R[..., 0, 0], R[..., 1, 0]))
    y = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    r = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([r, p, y], dim=-1)


def axis_angle_rot(axis, angle):
    """Rodrigues rotation about a (unit) axis. axis: (...,3), angle: (...,)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def crm(v, m):
    """Motion cross product v x m for motion vectors [ang; lin]."""
    w, vl = v[..., :3], v[..., 3:]
    wm, vm = m[..., :3], m[..., 3:]
    return torch.cat(
        [torch.linalg.cross(w, wm), torch.linalg.cross(w, vm) + torch.linalg.cross(vl, wm)],
        dim=-1,
    )


def crf(v, f):
    """Force cross product v x* f, f = [moment; force]."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat(
        [torch.linalg.cross(w, n) + torch.linalg.cross(vl, fl), torch.linalg.cross(w, fl)],
        dim=-1,
    )


def inertia_tensor_from_vec(ivec):
    """Symmetric 3x3 from [Ixx, Ixy, Ixz, Iyy, Iyz, Izz]."""
    ixx, ixy, ixz, iyy, iyz, izz = (ivec[..., k] for k in range(6))
    return torch.stack(
        [
            torch.stack([ixx, ixy, ixz], dim=-1),
            torch.stack([ixy, iyy, iyz], dim=-1),
            torch.stack([ixz, iyz, izz], dim=-1),
        ],
        dim=-2,
    )


def inertia_vec_from_tensor(I3):
    return torch.stack(
        [I3[..., 0, 0], I3[..., 0, 1], I3[..., 0, 2], I3[..., 1, 1], I3[..., 1, 2], I3[..., 2, 2]],
        dim=-1,
    )


def inertia_matrix_from_params(p10):
    """Spatial inertia (6x6, [ang;lin] ordering) from the 10 standard
    link-frame parameters [m, h, Ixx, Ixy, Ixz, Iyy, Iyz, Izz]."""
    m = p10[..., 0]
    h = p10[..., 1:4]
    Io = inertia_tensor_from_vec(p10[..., 4:10])
    Sh = skew(h)
    eye = torch.eye(3, dtype=p10.dtype, device=p10.device)
    top = torch.cat([Io, Sh], dim=-1)
    bot = torch.cat([-Sh, m[..., None, None] * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def L_of(w):
    """L(w) with L(w) @ ivec = I(ivec) @ w for the 6-vector inertia layout."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([wx, wy, wz, z, z, z], dim=-1),
            torch.stack([z, wx, z, wy, wz, z], dim=-1),
            torch.stack([z, z, wx, z, wy, wz], dim=-1),
        ],
        dim=-2,
    )
