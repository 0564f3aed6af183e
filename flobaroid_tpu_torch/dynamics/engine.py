"""Rigid-body dynamics engine on torch tensors.

Counterpart of flobaroid_tpu/dynamics/engine.py (see its docstring for
the conventions: world-origin Plücker coordinates, the reference column
layout of the standard regressor, iDynTree's mixed base representation).
The sample axis is a leading batch dimension N written out in every
function instead of a vmap; the structure constants are numpy arrays
built once in the constructor and turned into tensors once per
(dtype, device). Functions follow the dtype and device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from flobaroid_tpu.models.urdf import RobotTree, rpy_to_matrix

from . import spatial as sp


class DynamicsEngine:
    """Static robot structure + batched dynamics functions."""

    def __init__(self, tree: RobotTree, gravity=(0.0, 0.0, -9.81)):
        self.tree = tree
        L = tree.num_links
        n = tree.num_dofs
        self.num_links = L
        self.num_dofs = n
        self.gravity = np.asarray(gravity, dtype=float)

        # per-link joint data (joint connecting link to its parent)
        R0 = np.tile(np.eye(3), (L, 1, 1))
        p0 = np.zeros((L, 3))
        axis = np.zeros((L, 3))
        jtype = np.zeros(L, dtype=int)  # 0 fixed/root, 1 revolute, 2 prismatic
        dof_of_link = np.full(L, -1, dtype=int)
        # per-link generalized-coordinate map q_link = scale*q[dof]+offset
        # (identity except for mimic joints)
        q_scale = np.ones(L)
        q_offset = np.zeros(L)
        for i in range(L):
            ji = tree.parent_joint[i]
            if ji < 0:
                continue
            j = tree.joints[ji]
            R0[i] = rpy_to_matrix(j.origin_rpy)
            p0[i] = j.origin_xyz
            axis[i] = j.axis
            if j.jtype in ("revolute", "continuous"):
                jtype[i] = 1
            elif j.jtype == "prismatic":
                jtype[i] = 2
        for dj, ji in enumerate(tree.dof_joint_ids):
            dof_of_link[tree.link_index[tree.joints[ji].child]] = dj

        # mjoints: the n DOF joints (in dof order) followed by mimic
        # joints (q_m = mult*q[src_dof] + offset); the identity map over
        # dofs for a mimic-free model
        mimic = list(getattr(tree, "mimic_map", []))
        mj_link = list(np.asarray(tree.dof_link))
        mj_dof = list(range(n))
        mj_scale = [1.0] * n
        for (ji, src_dof, mult, off) in mimic:
            ci = tree.link_index[tree.joints[ji].child]
            mj_link.append(ci)
            mj_dof.append(src_dof)
            mj_scale.append(mult)
            dof_of_link[ci] = src_dof
            q_scale[ci] = mult
            q_offset[ci] = off
        self.has_mimic = bool(mimic)
        self.mjoint_link = np.asarray(mj_link, dtype=int)  # (m,)
        self.mjoint_dof = np.asarray(mj_dof, dtype=int)  # (m,)
        self.mjoint_scale = np.asarray(mj_scale, dtype=float)  # (m,)
        m = len(mj_link)
        # dof projection P[d, mj] = scale: generalized torques of the
        # mjoints back onto dofs (tau = P @ tau_m)
        P = np.zeros((n, m))
        P[self.mjoint_dof, np.arange(m)] = self.mjoint_scale
        self.dof_project = P

        self.R0, self.p0, self.axis = R0, p0, axis
        self.jtype, self.dof_of_link = jtype, dof_of_link
        self.q_scale_of_link, self.q_offset_of_link = q_scale, q_offset
        self.topo = tree.topo_order()
        self.parent = np.asarray(tree.parent_link)
        self.dof_link = np.asarray(tree.dof_link)

        # mask[i, j] = 1 iff mjoint j lies on the path root -> link i
        mj_of_link = np.full(L, -1, dtype=int)
        mj_of_link[self.mjoint_link] = np.arange(m)
        mask = np.zeros((L, m))
        for i in range(L):
            for li in tree.ancestors(i) + [i]:
                dj = mj_of_link[li]
                if dj >= 0:
                    mask[i, dj] = 1.0
        self.ancestor_mask = mask

        # depth levels for the level-synchronous FK: all links at one
        # tree depth transform in one batched step
        depth = np.zeros(L, dtype=int)
        for i in self.topo:
            pa = int(self.parent[i])
            depth[i] = 0 if pa < 0 else depth[pa] + 1
        self.levels = [np.where(depth == d)[0] for d in range(int(depth.max()) + 1)]
        self._consts: dict = {}

    # ------------------------------------------------------------------
    def _c(self, dtype, device) -> dict:
        """Structure constants as tensors of one dtype on one device."""
        key = (dtype, str(device))
        c = self._consts.get(key)
        if c is not None:
            return c

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        levels = []
        for idx in self.levels[1:]:
            jt = self.jtype[idx]
            levels.append(dict(
                idx=i(idx),
                par=i(self.parent[idx]),
                R0=f(self.R0[idx]),
                p0=f(self.p0[idx]),
                ax=f(self.axis[idx]),
                dj=i(np.maximum(self.dof_of_link[idx], 0)),
                has_dof=f(self.dof_of_link[idx] >= 0),
                qs=f(self.q_scale_of_link[idx]),
                qo=f(self.q_offset_of_link[idx]),
                is_rev=f(jt == 1)[:, None, None],
                is_pri=f(jt == 2)[:, None],
            ))
        dl = self.mjoint_link
        c = dict(
            levels=levels,
            dl=i(dl),
            axis_dl=f(self.axis[dl]),
            is_rev_dl=f(self.jtype[dl] == 1)[:, None],
            mjoint_dof=i(self.mjoint_dof),
            mjoint_scale=f(self.mjoint_scale),
            mask=f(self.ancestor_mask),
            dof_project=f(self.dof_project),
            gravity=f(self.gravity),
        )
        self._consts[key] = c
        return c

    # ------------------------------------------------------------------
    # kinematics
    # ------------------------------------------------------------------
    def fk(self, Q):
        """Forward kinematics in base coordinates.

        Q: (N, n) (or (n,) for one sample). Returns (R, p): (N, L, 3, 3)
        link orientations and (N, L, 3) link origins relative to the base
        link frame (without the N axis for a single sample)."""
        if Q.ndim == 1:
            R, p = self.fk(Q[None])
            return R[0], p[0]
        c = self._c(Q.dtype, Q.device)
        N, L = Q.shape[0], self.num_links
        R = torch.eye(3, dtype=Q.dtype, device=Q.device).expand(N, L, 3, 3).clone()
        p = torch.zeros((N, L, 3), dtype=Q.dtype, device=Q.device)
        for lv in c["levels"]:
            qj = (Q[:, lv["dj"]] * lv["qs"] + lv["qo"]) * lv["has_dof"]  # (N, k)
            Rrot = sp.axis_angle_rot(lv["ax"], qj)  # (N, k, 3, 3)
            Rj = lv["R0"] @ Rrot
            Rj = lv["is_rev"] * Rj + (1.0 - lv["is_rev"]) * lv["R0"]
            pj = lv["p0"] + lv["is_pri"] * (
                lv["R0"] @ (lv["ax"] * qj[..., None])[..., None]
            )[..., 0]
            Rpar = R[:, lv["par"]]
            R[:, lv["idx"]] = Rpar @ Rj
            p[:, lv["idx"]] = p[:, lv["par"]] + (Rpar @ pj[..., None])[..., 0]
        return R, p

    def _world_kinematics(self, Q, DQ, DDQ, BR, BV, BA):
        """World-frame link poses, per-mjoint motion subspaces s (about
        the world origin) and link spatial velocities/accelerations V, A
        (world coords, gravity folded in). All with a leading N axis."""
        c = self._c(Q.dtype, Q.device)
        Rb, pb = self.fk(Q)
        Rw = BR[:, None] @ Rb  # (N, L, 3, 3)
        pw = (BR[:, None] @ pb[..., None])[..., 0]  # (N, L, 3)

        dl = c["dl"]
        ax_w = (Rw[:, dl] @ c["axis_dl"][..., None])[..., 0]  # (N, m, 3)
        is_rev = c["is_rev_dl"]
        s_ang = is_rev * ax_w
        s_lin = is_rev * torch.linalg.cross(pw[:, dl], ax_w) + (1.0 - is_rev) * ax_w
        s = torch.cat([s_ang, s_lin], dim=-1)  # (N, m, 6)

        if self.has_mimic:
            dqm = DQ[:, c["mjoint_dof"]] * c["mjoint_scale"]
            ddqm = DDQ[:, c["mjoint_dof"]] * c["mjoint_scale"]
        else:
            dqm, ddqm = DQ, DDQ

        vlin, w = BV[:, :3], BV[:, 3:]
        alin, wdot = BA[:, :3], BA[:, 3:]
        v0 = torch.cat([w, vlin], dim=-1)
        # classical mixed -> spatial: a_O = p_dd - w x p_d; gravity trick
        a0 = torch.cat([wdot, alin - torch.linalg.cross(w, vlin) - c["gravity"]], dim=-1)

        mask = c["mask"]  # (L, m)
        V = v0[:, None] + mask @ (s * dqm[..., None])  # (N, L, 6)
        # d/dt s_j = v_{child(j)} x s_j (the axis is fixed in the child link)
        u = s * ddqm[..., None] + sp.crm(V[:, dl], s) * dqm[..., None]
        A = a0[:, None] + mask @ u
        return Rw, pw, s, V, A, mask

    @staticmethod
    def _body_frame_va(Rw, pw, V, A):
        """Rotate world-origin spatial vectors into link frames."""
        RwT = Rw.transpose(-1, -2)

        def rot(v):
            return (RwT @ v[..., None])[..., 0]

        w = rot(V[..., :3])
        vl = rot(V[..., 3:] + torch.linalg.cross(V[..., :3], pw))
        alpha = rot(A[..., :3])
        al = rot(A[..., 3:] + torch.linalg.cross(A[..., :3], pw))
        return w, vl, alpha, al

    # ------------------------------------------------------------------
    # regressor and inverse dynamics
    # ------------------------------------------------------------------
    @staticmethod
    def _link_regressor_blocks(w, vl, alpha, al):
        """Per-link 6x10 body-frame regressor blocks (..., 6, 10) with
        A @ [m, h, Ivec] = net spatial wrench [moment; force]."""
        lead = w.shape[:-1]
        zero31 = torch.zeros(lead + (3, 1), dtype=w.dtype, device=w.device)
        zero36 = torch.zeros(lead + (3, 6), dtype=w.dtype, device=w.device)
        wxv = torch.linalg.cross(w, vl)
        Sw = sp.skew(w)
        n_h = -sp.skew(al + wxv)
        n_I = sp.L_of(alpha) + Sw @ sp.L_of(w)
        f_m = (al + wxv)[..., None]
        f_h = sp.skew(alpha) + Sw @ Sw
        top = torch.cat([zero31, n_h, n_I], dim=-1)
        bot = torch.cat([f_m, f_h, zero36], dim=-1)
        return torch.cat([top, bot], dim=-2)

    @staticmethod
    def _force_to_world(Rw, pw, blk):
        """Per-link force-space columns from link frame to world-origin
        coords. blk: (N, L, 6, C) with rows [moment; force]."""
        n_l, f_l = blk[..., :3, :], blk[..., 3:, :]
        f_w = Rw @ f_l
        n_w = Rw @ n_l + torch.linalg.cross(
            pw[..., :, None].expand_as(f_w), f_w, dim=-2
        )
        return torch.cat([n_w, f_w], dim=-2)

    def _assemble_rows(self, s, mask, Fw, floating: bool):
        """Project per-link world wrench columns into output rows.

        Fw: (N, L, 6, C). Returns (N, rows, L, C). Row order: [f; n]
        base wrench (floating only), then joint torques."""
        Yj = torch.einsum("njd,nldc->njlc", s, Fw) * mask.T[None, :, :, None]
        if self.has_mimic:
            # generalized force on dof d sums every mjoint it drives,
            # weighted by the mimic multiplier: tau = P @ tau_mjoint
            P = self._c(Fw.dtype, Fw.device)["dof_project"]
            Yj = torch.einsum("dm,nmlc->ndlc", P, Yj)
        if not floating:
            return Yj
        # base wrench rows: swap [moment; force] -> [force; moment]
        Yb = torch.cat([Fw[..., 3:, :], Fw[..., :3, :]], dim=-2)
        return torch.cat([Yb.transpose(1, 2), Yj], dim=1)

    @staticmethod
    def _default_base(Q, BR, BV, BA):
        N = Q.shape[0]
        kw = dict(dtype=Q.dtype, device=Q.device)
        if BR is None:
            BR = torch.eye(3, **kw).expand(N, 3, 3)
        if BV is None:
            BV = torch.zeros((N, 6), **kw)
        if BA is None:
            BA = torch.zeros((N, 6), **kw)
        return BR, BV, BA

    def regressor_batch(self, Q, DQ, DDQ, base_rot=None, base_vel=None, base_acc=None):
        """Standard inertial-parameter regressor. Q/DQ/DDQ: (N, n); base
        args (N, 3, 3)/(N, 6)/(N, 6) for floating base or None.

        Returns (N, rows, 10L) with rows = 6+n (floating) or n, such that
        `Y @ pi` equals inverse dynamics [base wrench; joint torques]."""
        floating = base_rot is not None
        BR, BV, BA = self._default_base(Q, base_rot, base_vel, base_acc)
        Rw, pw, s, V, A, mask = self._world_kinematics(Q, DQ, DDQ, BR, BV, BA)
        w, vl, alpha, al = self._body_frame_va(Rw, pw, V, A)
        blk = self._link_regressor_blocks(w, vl, alpha, al)
        Fw = self._force_to_world(Rw, pw, blk)  # (N, L, 6, 10)
        Y = self._assemble_rows(s, mask, Fw, floating)  # (N, rows, L, 10)
        # link-major column order == reference layout
        return Y.reshape(Y.shape[0], Y.shape[1], self.num_links * 10)

    def regressor(self, q, dq, ddq, base_rot=None, base_vel=None, base_acc=None):
        """One sample: (rows, 10L)."""
        b = [None if a is None else a[None] for a in (base_rot, base_vel, base_acc)]
        return self.regressor_batch(q[None], dq[None], ddq[None], *b)[0]

    def inverse_dynamics_batch(
        self, pi, Q, DQ, DDQ, base_rot=None, base_vel=None, base_acc=None,
        floating: bool | None = None,
    ):
        """RNEA joint torques (+ base wrench when floating), (N, rows).

        pi: (10L,) standard parameters. Computed from explicit spatial
        inertias (I a + v x* I v), not via the regressor, so the
        `regressor @ pi == inverse_dynamics` identity is a real
        cross-check between two formulations."""
        if floating is None:
            floating = base_rot is not None
        BR, BV, BA = self._default_base(Q, base_rot, base_vel, base_acc)
        Rw, pw, s, V, A, mask = self._world_kinematics(Q, DQ, DDQ, BR, BV, BA)
        w, vl, alpha, al = self._body_frame_va(Rw, pw, V, A)
        I6 = sp.inertia_matrix_from_params(pi.reshape(self.num_links, 10))  # (L, 6, 6)
        vb = torch.cat([w, vl], dim=-1)
        ab = torch.cat([alpha, al], dim=-1)
        f = (I6 @ ab[..., None])[..., 0] + sp.crf(vb, (I6 @ vb[..., None])[..., 0])
        Fw = self._force_to_world(Rw, pw, f[..., None])  # (N, L, 6, 1)
        out = self._assemble_rows(s, mask, Fw, floating)  # (N, rows, L, 1)
        return out[..., 0].sum(dim=-1)

    def inverse_dynamics(self, pi, q, dq, ddq, base_rot=None, base_vel=None,
                         base_acc=None, floating: bool | None = None):
        """One sample: (rows,)."""
        b = [None if a is None else a[None] for a in (base_rot, base_vel, base_acc)]
        return self.inverse_dynamics_batch(
            pi, q[None], dq[None], ddq[None], *b, floating=floating)[0]


def rpy_to_base_rot(rpy):
    """npz `base_rpy` to world_R_base (world_R_base = RPY(rpy)^T, the
    storage convention of the JAX package's rpy_to_base_rot)."""
    return sp.rpy_to_rot(rpy).transpose(-1, -2)


def rpy_to_base_rot_np(rpy):
    """Host (numpy) form of rpy_to_base_rot."""
    return np.swapaxes(sp.rpy_to_rot_np(rpy), -1, -2)
