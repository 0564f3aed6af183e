"""Suspended-base (crane ball-joint) dynamics.

Counterpart of flobaroid_tpu/excitation/suspended.py (reference
excitation/suspendedDynamics.py:21-293): a robot hangs from a ball joint
at `attachment_frame` (free rotation, pinned translation); per time step
the attachment's angular acceleration is solved from the Newton-Euler
moment balance about the attachment point with implicit viscous damping,
integrated by semi-implicit Euler with a soft +-25 deg swing clamp, and
the identification base link's pose/velocity series is derived by
forward kinematics.

The moment balance is formed directly in world-origin Plücker
coordinates from the root-based engine:

    moment about attachment  n_a(alpha) = A alpha + n0

with n0 from one inverse-dynamics pass (alpha = 0; includes gravity,
joint accelerations, velocity products) and A the composite rigid-body
inertia about the attachment in closed form.

The time loop is a Python loop, one step for all candidates at once:
every state-carrying function takes a leading candidate axis K. What
does not depend on the integrator state (the forward kinematics of every
sample and the attachment inertia in root coordinates, which a step only
rotates into the world frame) is computed for all K x N samples before
the loop. Everything is differentiable by torch.autograd.

Conventions (matching the reference):
  * att_rpy parametrizes world_R_attachment = RPY(att_rpy) directly
    (suspendedDynamics.py:136-140 uses Transform WITHOUT inverse),
  * the returned base_rpy series uses the npz storage convention
    world_R_base = RPY(rpy)^T (suspendedDynamics.py:176-182),
  * base_velocity is the mixed twist [linear; angular] of the base
    link frame, base_acceleration its central-difference derivative.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..dynamics import spatial as sp
from ..dynamics.engine import DynamicsEngine
from ..models.urdf import RobotTree
from ..utils.tensor_ops import clip

_cross = torch.linalg.cross


def euler_map_direct(rpy):
    """E with omega_world = E @ rpy_dot for R = RPY(rpy) = Rz Ry Rx (no
    transpose), over any leading axes: the columns are the world axes of
    the roll, pitch and yaw rotations."""
    p, y = rpy[..., 1], rpy[..., 2]
    cp, sp_ = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    zero, one = torch.zeros_like(p), torch.ones_like(p)
    return torch.stack(
        [
            torch.stack([cy * cp, -sy, zero], dim=-1),
            torch.stack([sy * cp, cy, zero], dim=-1),
            torch.stack([-sp_, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _solve(A, b):
    """Batched A x = b without the host read of the error check."""
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def angular_velocity_to_rpy_rates(rpy, omega):
    return _solve(euler_map_direct(rpy), omega)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class SuspendedSimulator:
    def __init__(
        self,
        tree: RobotTree,
        attachment_frame: str,
        base_link: str | None = None,
        damping: float = 500.0,
        pi: np.ndarray | None = None,
        max_swing_deg: float = 25.0,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.engine = DynamicsEngine(tree)
        if self.engine.has_mimic:
            # this integrator indexes motion subspaces per DOF; folding
            # mimic columns here is untested — fail loudly, never wrong
            raise NotImplementedError(
                "suspended-base simulation does not support mimic joints"
            )
        if attachment_frame not in tree.link_index:
            raise ValueError(f"attachment frame '{attachment_frame}' not in model links")
        self.att = tree.link_index[attachment_frame]
        self.bl = tree.link_index[base_link] if base_link else tree.root
        self.damping = float(damping)
        self.pi = np.asarray(pi if pi is not None else tree.std_params(), dtype=float)
        self.max_swing = float(np.deg2rad(max_swing_deg))
        self._pi_t: dict = {}

    def _pi(self, like):
        key = (like.dtype, str(like.device))
        if key not in self._pi_t:
            self._pi_t[key] = torch.as_tensor(self.pi, dtype=like.dtype, device=like.device)
        return self._pi_t[key]

    def _t(self, a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # every function below takes a leading candidate axis K
    # ------------------------------------------------------------------
    def _root_state(self, q, att_rpy, att_omega, dq, fk=None):
        """Root-link pose/velocity consistent with the attachment state.
        q, dq: (K, n); att_rpy, att_omega: (K, 3); fk: the engine's
        (Rb, pb) of q when the caller has them."""
        eng = self.engine
        c = eng._c(q.dtype, q.device)
        R_wa = sp.rpy_to_rot(att_rpy)
        Rb, pb = eng.fk(q) if fk is None else fk
        R_wr = R_wa @ Rb[:, self.att].transpose(-1, -2)
        pw = _mv(R_wr[:, None], pb)
        p_a = pw[:, self.att]
        # motion subspaces in world-origin coords (root pinned at origin)
        dl = c["dl"]
        Rw = R_wr[:, None] @ Rb
        ax_w = _mv(Rw[:, dl], c["axis_dl"])
        is_rev = c["is_rev_dl"]
        s = torch.cat(
            [is_rev * ax_w, is_rev * _cross(pw[:, dl], ax_w) + (1 - is_rev) * ax_w], dim=-1)
        mask = c["mask"]
        # attachment spatial velocity (world origin): [omega_a; -omega_a x p_a]
        v_a = torch.cat([att_omega, -_cross(att_omega, p_a)], dim=-1)
        v_r = v_a - _mv(s.transpose(1, 2), mask[self.att] * dq)
        return R_wr, pw, p_a, s, mask, v_r

    def _moment_about_attachment(self, q, dq, ddq, R_wr, v_r, p_a, alpha, s, mask, fk=None):
        """Inverse dynamics with attachment angular acceleration `alpha`;
        returns the moment of the required wrench about the attachment."""
        eng = self.engine
        # attachment spatial acceleration: [alpha; -alpha x p_a]
        a_a = torch.cat([alpha, -_cross(alpha, p_a)], dim=-1)
        # subtract joint contributions along the path to get root spatial acc
        # a_r = a_a - sum_j (s_j ddq_j + (v_{child(j)} x s_j) dq_j)
        dl = eng._c(q.dtype, q.device)["dl"]
        V = v_r[:, None] + mask @ (s * dq[..., None])
        u = s * ddq[..., None] + sp.crm(V[:, dl], s) * dq[..., None]
        a_r = a_a - (mask[self.att][:, None] * u).sum(dim=1)
        # convert spatial root vel/acc to the engine's mixed interface
        w_r = v_r[:, :3]
        vlin_mixed = v_r[:, 3:]  # root at origin: v(0) == spatial linear
        a_lin_mixed = a_r[:, 3:] + _cross(w_r, vlin_mixed)
        base_vel = torch.cat([vlin_mixed, w_r], dim=-1)
        base_acc = torch.cat([a_lin_mixed, a_r[:, :3]], dim=-1)
        out = eng.inverse_dynamics_batch(
            self._pi(q), q, dq, ddq, R_wr, base_vel, base_acc, fk=fk)
        f, n_O = out[:, :3], out[:, 3:6]
        return n_O - _cross(p_a, f)

    def _locked_attachment_inertia(self, q, R_wr, pw, p_a, fk=None):
        """Closed-form alpha-response matrix A: the moment about the
        attachment is AFFINE in the attachment angular acceleration
        (n(alpha) = n0 + A alpha with q, dq, ddq held fixed — a unit
        alpha rigidly accelerates the WHOLE mechanism about the
        attachment point), so A is the composite rigid-body angular
        inertia about the attachment:
            A = I_tot(O) + p h^T + h p^T - 2 (h.p) E - m_tot (p p^T - |p|^2 E)
        with (m_tot, h, I_tot) the total mass / first moment / rotational
        inertia at the WORLD ORIGIN and p = p_a. Replaces three
        unit-alpha RNEA sweeps per integration step; parity with that
        construction is asserted in the tests."""
        eng = self.engine
        P = self._pi(R_wr).reshape(-1, 10)
        m = P[:, 0]
        h_l = P[:, 1:4]
        I_l = sp.inertia_tensor_from_vec(P[:, 4:10])  # (L, 3, 3) about the link frame
        Rb, _ = eng.fk(q) if fk is None else fk
        Rw = R_wr[:, None] @ Rb
        Iw = Rw @ I_l @ Rw.transpose(-1, -2)
        hw = _mv(Rw, h_l)  # first moment about o_l
        o = pw
        E = torch.eye(3, dtype=R_wr.dtype, device=R_wr.device)

        def outer(a, b):
            return a[..., :, None] * b[..., None, :]

        # translate each link's rotational inertia from its origin o_l
        # to the world origin: I_O = I_o + (h.d + d.h) E - d h^T - h d^T
        # + m (|d|^2 E - d d^T), d = o_l  (S(a)S(b)^T = (a.b)E - b a^T)
        hd = (hw * o).sum(dim=-1)
        dd = (o * o).sum(dim=-1)
        I_O = (
            Iw
            + (2.0 * hd + m * dd)[..., None, None] * E
            - outer(o, hw)
            - outer(hw, o)
            - m[:, None, None] * outer(o, o)
        )
        I_tot = I_O.sum(dim=1)
        h_tot = (hw + m[:, None] * o).sum(dim=1)
        m_tot = m.sum()
        p = p_a
        hp = (h_tot * p).sum(dim=-1)[:, None, None]
        pp = (p * p).sum(dim=-1)[:, None, None]
        return (
            I_tot
            + outer(p, h_tot) + outer(h_tot, p) - 2.0 * hp * E
            - m_tot * (outer(p, p) - pp * E)
        )

    def _step_dynamics(self, q, dq, ddq, att_rpy, att_omega, dt, fk, A_root):
        """Solve (A + c*dt*I) alpha = -n0 - c*omega (implicit damping).
        fk: the engine's (Rb, pb) of q; A_root: the attachment inertia in
        root coordinates (`_locked_attachment_inertia` with an identity
        root rotation), which R_wr rotates into the world frame."""
        R_wr, pw, p_a, s, mask, v_r = self._root_state(q, att_rpy, att_omega, dq, fk=fk)
        n0 = self._moment_about_attachment(
            q, dq, ddq, R_wr, v_r, p_a, torch.zeros_like(att_omega), s, mask, fk=fk)
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        A = R_wr @ A_root @ R_wr.transpose(-1, -2)
        c = self.damping
        alpha = _solve(A + c * dt * eye, -n0 - c * att_omega)
        return alpha, R_wr, pw, p_a, s, mask, v_r

    def simulate_core(self, positions, velocities, accelerations, att_rpy0, dt):
        """Differentiable ball-joint integration.

        positions / velocities / accelerations: (N, n) for one
        trajectory or (K, N, n) for K candidates advanced together;
        att_rpy0: (3,) (shared) or (K, 3). Returns (base_rpy (.., N, 3),
        base_position (.., N, 3), base_velocity (.., N, 6)); the
        acceleration differencing and the equilibrium search live in the
        host wrapper `simulate`."""
        if positions.ndim == 2:
            out = self.simulate_core(positions[None], velocities[None], accelerations[None],
                                     att_rpy0, dt)
            return tuple(o[0] for o in out)
        eng = self.engine
        bl = self.bl
        K, N, n = positions.shape
        kw = dict(dtype=positions.dtype, device=positions.device)
        Rb_all, pb_all = eng.fk(positions.reshape(K * N, n))
        # attachment inertia in root coordinates, every sample at once
        eye_all = torch.eye(3, **kw).expand(K * N, 3, 3)
        A_root = self._locked_attachment_inertia(
            None, eye_all, pb_all, pb_all[:, self.att], fk=(Rb_all, pb_all)
        ).reshape(K, N, 3, 3)
        Rb_all = Rb_all.reshape(K, N, *Rb_all.shape[1:])
        pb_all = pb_all.reshape(K, N, *pb_all.shape[1:])

        att_rpy = torch.as_tensor(att_rpy0, **kw).expand(K, 3)
        att_omega = torch.zeros((K, 3), **kw)
        rpy_s, pos_s, vel_s = [], [], []
        for t in range(N):
            q, dq, ddq = positions[:, t], velocities[:, t], accelerations[:, t]
            fk = (Rb_all[:, t], pb_all[:, t])
            alpha, R_wr, pw, p_a, s, mask, v_r = self._step_dynamics(
                q, dq, ddq, att_rpy, att_omega, dt, fk, A_root[:, t])
            # base link outputs (before integrating, like the reference)
            R_w_bl = R_wr @ fk[0][:, bl]
            rpy_s.append(sp.rot_to_rpy(R_w_bl.transpose(-1, -2)))  # storage convention
            pos_s.append(pw[:, bl] - p_a)  # attachment pinned at world origin
            v_bl = v_r + _mv(s.transpose(1, 2), mask[bl] * dq)
            lin = v_bl[:, 3:] + _cross(v_bl[:, :3], pw[:, bl])
            vel_s.append(torch.cat([lin, v_bl[:, :3]], dim=-1))

            # semi-implicit Euler + soft swing clamp with elastic bounce
            att_omega = att_omega + alpha * dt
            rpy_dot = angular_velocity_to_rpy_rates(att_rpy, att_omega)
            att_rpy = att_rpy + rpy_dot * dt
            over = att_rpy > self.max_swing
            under = att_rpy < -self.max_swing
            # outward motion is judged in rpy-rate space (rpy_dot), not
            # world angular velocity: with nonzero yaw the E(rpy) map is
            # non-diagonal, and an att_omega-sign test could keep pushing
            # outward without ever triggering the bounce
            att_omega = torch.where(over & (rpy_dot > 0), -0.3 * att_omega, att_omega)
            att_omega = torch.where(under & (rpy_dot < 0), -0.3 * att_omega, att_omega)
            att_rpy = clip(att_rpy, -self.max_swing, self.max_swing)
        return torch.stack(rpy_s, dim=1), torch.stack(pos_s, dim=1), torch.stack(vel_s, dim=1)

    @staticmethod
    def acceleration_from_velocity(vel_s, dt):
        """Central-difference base acceleration along the sample axis
        (the second to last)."""
        v = vel_s
        inner = (v[..., 2:, :] - v[..., :-2, :]) / (2 * dt)
        first = (v[..., 1:2, :] - v[..., 0:1, :]) / dt
        last = (v[..., -1:, :] - v[..., -2:-1, :]) / dt
        return torch.cat([first, inner, last], dim=-2)

    def simulate(self, positions, velocities, accelerations, times, initial_rpy=None,
                 dtype=torch.float64):
        """Run the ball-joint integration over the whole trajectory on
        the simulator's device.

        Returns numpy (base_rpy (N,3), base_velocity (N,6),
        base_acceleration (N,6), base_position (N,3)) — same contract as
        the reference (suspendedDynamics.py:21-232). initial_rpy
        overrides the static equilibrium start (used by tests)."""
        times = np.asarray(times)
        N = len(np.asarray(positions))
        dt = float(times[1] - times[0]) if N > 1 else 1.0 / 200.0
        if initial_rpy is None:
            att_rpy0 = self.find_equilibrium_rpy(np.asarray(positions)[0])
        else:
            att_rpy0 = np.asarray(initial_rpy, dtype=float)
        with torch.no_grad():
            rpy_s, pos_s, vel_s = self.simulate_core(
                self._t(positions, dtype), self._t(velocities, dtype),
                self._t(accelerations, dtype), self._t(att_rpy0, dtype), dt)
            acc_s = self.acceleration_from_velocity(vel_s, dt)

        def host(a):
            return a.double().cpu().numpy()

        return host(rpy_s), host(vel_s), host(acc_s), host(pos_s)

    # ------------------------------------------------------------------
    def find_equilibrium_rpy(self, q0, max_iterations=200, tol=0.01):
        """Static equilibrium attachment orientation: descend the gravity
        moment about the attachment (reference suspendedDynamics.py:235-293),
        in f64, one host read of the moment's norm per step."""
        step = 1.0 / 700.0
        lim = float(np.deg2rad(30))
        q0 = self._t(q0)[None]
        zero_n = torch.zeros_like(q0)
        zero3 = torch.zeros((1, 3), dtype=q0.dtype, device=q0.device)
        with torch.no_grad():
            fk = self.engine.fk(q0)

            def moment(att_rpy):
                R_wr, pw, p_a, s, mask, v_r = self._root_state(q0, att_rpy, zero3, zero_n, fk=fk)
                return self._moment_about_attachment(
                    q0, zero_n, zero_n, R_wr, v_r, p_a, zero3, s, mask, fk=fk)

            rpy = zero3
            nrm = float(torch.linalg.norm(moment(rpy)))
            it = 0
            while it < max_iterations and nrm >= tol:
                n = moment(rpy)
                nrm = float(torch.linalg.norm(n))
                rpy = torch.clamp(rpy - step * n, -lim, lim)
                it += 1
        return rpy[0].cpu().numpy()


def simulate_suspended_base_motion(
    urdf_file_or_tree,
    positions,
    velocities,
    accelerations,
    times,
    attachment_frame: str = "crane_ft",
    base_link: str | None = None,
    damping: float = 500.0,
    *,
    device="cuda",
    dtype=torch.float64,
):
    """Functional wrapper matching the reference's signature
    (suspendedDynamics.py:21)."""
    from ..models.urdf import load_urdf

    tree = (
        urdf_file_or_tree
        if isinstance(urdf_file_or_tree, RobotTree)
        else load_urdf(urdf_file_or_tree)
    )
    sim = SuspendedSimulator(tree, attachment_frame, base_link, damping, device=device)
    return sim.simulate(positions, velocities, accelerations, times, dtype=dtype)
