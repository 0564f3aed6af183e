"""Static posture optimization for gravity-parameter identification.

Counterpart of flobaroid_tpu/excitation/posture.py (reference
excitation/postureOptimizer.py:19-292): choose `numStaticPostures` joint
configurations whose stacked gravity regressor best determines the
mass/first-moment parameters.

The default objective is the regularized D-optimality of the stacked
gravity regressor (ground-truth free); with `x_std_real` it is the
reference's ||xBaseReal - xBase||^2 with the identification (one ridge
solve on exact simulated torques) inside the loop. A cross-entropy search
evaluates each generation's population in one batched device call, then
Adam (optax's defaults, written out) refines the best posture set on the
autograd gradient. Random draws are numpy's, in the JAX module's order.
The objective runs in `dtype` on the model's device: float32 by default,
as the JAX package runs it whatever `computeDtype` is.
"""

from __future__ import annotations

import numpy as np
import torch


def posture_bounds(model) -> tuple[np.ndarray, np.ndarray]:
    """Per-joint posture bounds: the URDF limits, +-pi where unlimited."""
    lims = model.limits
    lo = np.array([lims[j]["lower"] for j in model.jointNames])
    hi = np.array([lims[j]["upper"] for j in model.jointNames])
    return np.where(np.isfinite(lo), lo, -np.pi), np.where(np.isfinite(hi), hi, np.pi)


def posture_objective(model, config, x_std_real=None, dtype=torch.float32):
    """The batched objective of `optimize_postures`: a function of K
    posture sets X (K, numStaticPostures * n) on the model's device in
    `dtype`, returning (K,) values (differentiable).

    With `x_std_real` (ground-truth std params over the model's 10L
    inertial slots, reference --model_real) the objective is the
    reference's ||xBaseReal - xBase||^2 with the identification run
    inside the loop; it requires the model to be built with
    identifyGravityParamsOnly=1 and no simultaneous friction, so the
    identified columns are exactly the gravity columns."""
    eng = model.engine
    dev = model.device
    nd = model.num_dofs
    n_post = max(int(config.get("numStaticPostures", 5)), 2)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=dev)

    keep = [p for p in range(model.num_model_params) if p % 10 < 4]
    keep_t = torch.as_tensor(keep, device=dev)
    proj = (
        getattr(model, "B", None)
        if config.get("useBasisProjection", 0)
        else getattr(model, "Pb", None)
    )
    Pb = t(proj) if proj is not None else None
    floating = bool(config["floatingBase"])

    def raw_rows(X):
        """Gravity-regressor rows (K, n_post*rows, P_keep) of K posture
        sets X (K, n_post*nd), zero velocity and acceleration."""
        K = X.shape[0]
        Qs = X.reshape(K * n_post, nd)
        Z = torch.zeros_like(Qs)
        if floating:
            # identity base rotation, zero base velocity and acceleration
            eye = torch.eye(3, dtype=dtype, device=dev).expand(K * n_post, 3, 3)
            z6 = torch.zeros((K * n_post, 6), dtype=dtype, device=dev)
            Y = eng.regressor_batch(Qs, Z, Z, eye, z6, z6)
        else:
            Y = eng.regressor_batch(Qs, Z, Z)
        Y = Y[:, :, keep_t]
        return Y.reshape(K, -1, Y.shape[-1])

    # reference-parity objective (postureOptimizer.py:93-180): simulate
    # torques with the REAL parameters, identify on the candidate
    # postures, minimize ||xBaseReal - xBase||^2; with exact torques and
    # OLS the inner identification is one ridge solve
    parity = x_std_real is not None
    if parity:
        if Pb is None or Pb.shape[0] != len(keep):
            raise ValueError(
                "posture parity objective needs identifyGravityParamsOnly=1 "
                "(and identifyFrictionSimultaneously=0) so the base "
                "projection covers exactly the gravity columns "
                f"(Pb rows {None if Pb is None else Pb.shape[0]} != {len(keep)})"
            )
        pi_real_np = np.asarray(x_std_real, dtype=float)[keep]
        if config.get("useBasisProjection", 0):
            # pinv(B), matching identifier.xBaseReal
            xb_real_np = np.asarray(model.Binv) @ pi_real_np
        else:
            xb_real_np = np.asarray(model.K) @ pi_real_np
        xb_real = t(xb_real_np)
        pi_real = t(pi_real_np)

    def objective(X):
        """Objective values (K,) of K posture sets X (K, n_post*nd)."""
        Yf = raw_rows(X)
        if parity:
            YB = Yf @ Pb
            tau = Yf @ pi_real
            # the ridge is the observability floor: base directions the
            # postures leave below it keep their full ||xb_real|| error
            GB = YB.transpose(1, 2) @ YB
            nb = GB.shape[-1]
            ridge = 1e-8 * GB.diagonal(dim1=-2, dim2=-1).sum(-1) / nb
            eye = torch.eye(nb, dtype=dtype, device=dev)
            xb = torch.linalg.solve(GB + ridge[:, None, None] * eye,
                                    (YB.transpose(1, 2) @ tau[..., None])[..., 0])
            return ((xb - xb_real) ** 2).sum(dim=-1)
        G = Yf.transpose(1, 2) @ Yf
        ev = torch.linalg.eigvalsh(G)
        delta = 1e-4 * torch.clamp_min(ev[:, -1:], 1e-30)
        return -torch.log(ev + delta).sum(dim=-1)

    return objective


def optimize_postures(model, config, x_std_real=None, rng=None, dtype=torch.float32):
    """Returns a list of `numStaticPostures` joint-angle vectors, the
    minimizer of `posture_objective` (the D-optimality of the gravity
    regressor, or with `x_std_real` the reference's identification error)
    found by a cross-entropy search and an Adam refinement."""
    rng = rng or np.random.default_rng(int(config.get("trajectoryOptSeed", 0)))
    nd = model.num_dofs
    n_post = max(int(config.get("numStaticPostures", 5)), 2)
    lo, hi = posture_bounds(model)
    objective = posture_objective(model, config, x_std_real, dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=model.device)

    def values(X):
        with torch.no_grad():
            return objective(t(X)).double().cpu().numpy()

    def grad(x):
        xt = t(x)[None].requires_grad_(True)
        (g,) = torch.autograd.grad(objective(xt).sum(), xt)
        return g[0].double().cpu().numpy()

    dim = n_post * nd
    lo_f = np.tile(lo, n_post)
    hi_f = np.tile(hi, n_post)
    mean = lo_f + (hi_f - lo_f) * rng.random(dim)
    # seed with configured initial postures (reference
    # postureOptimizer.py:241-250; degrees when useDeg)
    init_postures = config.get("initialPostures") or []
    for p_i, angles in enumerate(init_postures[:n_post]):
        a = np.asarray(angles, dtype=float)[:nd]
        if config.get("useDeg", 0):
            a = np.deg2rad(a)
        mean[p_i * nd : p_i * nd + len(a)] = a
    sigma = 0.3 * (hi_f - lo_f)
    pop = max(int(config.get("globalOptSize", 12)), 8)
    best, best_v = mean.copy(), np.inf
    for _ in range(max(int(config.get("globalOptIterations", 10)), 1)):
        X = np.clip(mean + sigma * rng.standard_normal((pop, dim)), lo_f, hi_f)
        X[0] = np.clip(best, lo_f, hi_f)
        v = values(X)
        order = np.argsort(v)
        if v[order[0]] < best_v:
            best_v, best = float(v[order[0]]), X[order[0]].copy()
        elite = X[order[: max(pop // 4, 2)]]
        mean = elite.mean(axis=0)
        sigma = elite.std(axis=0) * 1.2 + 1e-3

    if config.get("useLocalOptimization", 1):
        # Adam with optax's defaults: lr 0.02, b1 0.9, b2 0.999, eps 1e-8,
        # bias correction
        lr, b1, b2, eps = 0.02, 0.9, 0.999, 1e-8
        x = best.copy()
        m = np.zeros_like(x)
        nu = np.zeros_like(x)
        for step in range(1, 201):
            g = grad(x)
            if not np.all(np.isfinite(g)):
                break
            m = b1 * m + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * g * g
            m_hat = m / (1.0 - b1**step)
            nu_hat = nu / (1.0 - b2**step)
            x = np.clip(x - lr * m_hat / (np.sqrt(nu_hat) + eps), lo_f, hi_f)
        if values(x[None])[0] < best_v:
            best = x
    return [best.reshape(n_post, nd)[i] for i in range(n_post)]
