"""The reference's side of an identification: the normal equations of a
recording in float64, their least-squares optimum, and the numbers that
judge an identification against them.

The identified columns are the ten inertial parameters of every link in
link order, then (with friction) [Fc, Fv, offset] per joint. The fitted
rows are the measured torques with the measured contact wrenches taken
out, t = tau_m - J^T w, where tau_m is the measured torque with J^T w
added to the base rows (their measurement is the net base wrench). The
toolkit's residual is ||t - Y x|| / ||tau_m||, in percent.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rigid_body as rb

CHUNK = 4096


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _state(rec, sl, device, fb):
    d = lambda k: torch.as_tensor(np.asarray(rec[k])[sl], dtype=torch.float64, device=device)  # noqa: E731
    base = None
    if fb:
        base = (rb.rpy_matrix_t(d("base_rpy")).transpose(-1, -2),
                d("base_velocity"), d("base_acceleration"))
    return d("positions"), d("velocities"), d("accelerations"), base


def normal_equations(robot, rec, options, device, control: bool = False) -> dict:
    """G = Y^T Y, g = Y^T t, tt = t^T t and tm2 = ||tau_m||^2 over the
    recording, plus per-row G and g of the base rows (floating base).

    control=False: float64 throughout. control=True: the same in the
    nearest lower precision than the toolkit's float32: Y and t in
    float32 rounded to TF32, products summed in float32 per chunk."""
    fb = 6 if options.get("floatingBase", 0) else 0
    N = rec["positions"].shape[0]
    contacts = rec["contacts"].item(0) if "contacts" in rec else {}
    acc = None
    for s in range(0, N, CHUNK):
        sl = slice(s, s + CHUNK)
        Q, V, A, base = _state(rec, sl, device, fb)
        Y = rb.regressor(robot, Q, V, A, base)
        if options.get("identifyFrictionSimultaneously", 0):
            Y = torch.cat([Y, rb.friction_columns(V, options["frictionSignThreshold"], fb)], dim=2)
        tau = torch.as_tensor(rec["torques"][sl], dtype=torch.float64, device=device)
        cf = torch.zeros_like(tau)
        for frame, w in contacts.items():
            cf += rb.contact_torques(robot, robot.link_names.index(frame), Q, base[0],
                                     torch.as_tensor(w[sl], dtype=torch.float64, device=device))
        tau_m = tau.clone()
        tau_m[:, :fb] += cf[:, :fb]
        t = tau_m - cf
        Yt = torch.cat([Y, t[..., None]], dim=2)  # (n, rows, P + 1)
        if control:
            Yt = tf32(Yt)
        per_row = torch.einsum("nrp,nrq->rpq", Yt, Yt).double()  # (rows, P+1, P+1)
        part = dict(aug=per_row.sum(0), base=per_row[:fb], tm2=float((tau_m ** 2).sum()))
        if acc is None:
            acc = part
        else:
            acc = {k: acc[k] + part[k] for k in acc}
    P = acc["aug"].shape[0] - 1
    aug, base = acc["aug"].cpu().numpy(), acc["base"].cpu().numpy()
    return dict(G=aug[:P, :P], g=aug[:P, P], tt=float(aug[P, P]), tm2=acc["tm2"],
                G_base_rows=base[:, :P, :P], g_base_rows=base[:, :P, P])


def least_squares(ne: dict, rcond: float = 1e-10) -> np.ndarray:
    """Minimum-norm solution of G x = g, by an eigendecomposition of the
    column-scaled G with eigenvalues below rcond * max dropped (the
    structural null space of the regressor)."""
    d = np.sqrt(np.maximum(np.diag(ne["G"]), 1e-300))
    Gs = ne["G"] / np.outer(d, d)
    lam, U = np.linalg.eigh(Gs)
    keep = lam > rcond * lam.max()
    xs = U[:, keep] @ ((U[:, keep].T @ (ne["g"] / d)) / lam[keep])
    return xs / d


def residual_pct(ne: dict, x: np.ndarray) -> float:
    r2 = ne["tt"] - 2 * x @ ne["g"] + x @ ne["G"] @ x
    return float(100.0 * np.sqrt(max(r2, 0.0) / ne["tm2"]))


def inconsistency(x: np.ndarray, num_links: int) -> float:
    """Largest negative eigenvalue of the links' 6x6 spatial inertias, as a
    share of the largest eigenvalue of any link (0 when every link is
    physically consistent)."""
    lam = np.array([np.linalg.eigvalsh(rb.spatial_inertia(x[10 * i:10 * i + 10]))
                    for i in range(num_links)])
    return float(max(0.0, -lam[:, 0].min()) / lam[:, -1].max())


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def judge(units: list, refs: list, num_links: int, base_rows=None) -> dict:
    """Numbers for a set of identifications, each the worst over them:

    gram_rel_err: relative distance of the identification's G and g from
      the reference's (the regressor and Gram pass, contacts folded in);
    base_rows_rel_err: the same for the base rows' own G and g;
    resid_report_gap_pct: the reported residual against the residual of
      the identified x on the reference's normal equations;
    resid_gap_pct: the reported residual against the reference's
      least-squares optimum (with the one above it bounds how much the
      identified x fits worse than the best fit);
    inconsistency: of the identified standard parameters.

    units: dicts with the variant v, the identified x, the reported
    residual res (%), and the toolkit's normal equations G and g; refs:
    normal_equations per variant, each with its least-squares residual
    res_min. base_rows: (v, G (6, P, P), g (6, P)) of one identification's
    base rows, or None."""
    out = dict(gram_rel_err=0.0, resid_report_gap_pct=0.0, resid_gap_pct=0.0,
               inconsistency=0.0)
    for u in units:
        ref = refs[u["v"]]
        res = residual_pct(ref, u["x"])
        out["gram_rel_err"] = max(out["gram_rel_err"], _rel(u["G"], ref["G"]), _rel(u["g"], ref["g"]))
        out["resid_report_gap_pct"] = max(out["resid_report_gap_pct"], abs(u["res"] - res))
        out["resid_gap_pct"] = max(out["resid_gap_pct"], abs(u["res"] - ref["res_min"]))
        out["inconsistency"] = max(out["inconsistency"], inconsistency(u["x"], num_links))
    if base_rows is not None:
        v, Gb, gb = base_rows
        out["base_rows_rel_err"] = max(_rel(Gb, refs[v]["G_base_rows"]), _rel(gb, refs[v]["g_base_rows"]))
    return out


def reference_side(robot, recordings, options, device, control=False) -> list:
    """normal_equations and the least-squares residual of every recording."""
    refs = []
    for rec in recordings:
        ne = normal_equations(robot, rec, options, device, control)
        ne["x_ls"] = least_squares(ne)
        ne["res_min"] = residual_pct(ne, ne["x_ls"])
        refs.append(ne)
    return refs


def control_units(robot, recordings, options, device) -> tuple:
    """The reference in the toolkit's place at TF32: per recording its
    normal equations, least-squares x and residual, as identifications
    for `judge`, and its base rows."""
    ctrl = reference_side(robot, recordings, options, device, control=True)
    units = [dict(v=k, x=c["x_ls"], res=c["res_min"], G=c["G"], g=c["g"]) for k, c in enumerate(ctrl)]
    fb = options.get("floatingBase", 0)
    base_rows = (len(ctrl) - 1, ctrl[-1]["G_base_rows"], ctrl[-1]["g_base_rows"]) if fb else None
    return units, base_rows
