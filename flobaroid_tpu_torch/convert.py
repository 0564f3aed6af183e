"""Carry a model's "weights" across from the JAX package to the port.

For this system the weights are the URDF a-priori parameter vector and
the structural base projection (the pivoted QR of the structural Gram
and everything derived from it). The JAX package draws its structural
states with jax.random and the port with a torch.Generator, so the two
structural Grams differ in value; installing one model's state into the
other makes both compute with an identical projection, which is what a
value-level comparison of the two packages needs.

`state_from_jax_model` reads attributes only: it imports neither JAX nor
the JAX package (the caller holds the model).
"""

from __future__ import annotations

import numpy as np


def state_from_jax_model(m) -> dict[str, np.ndarray]:
    """State dict of a flobaroid_tpu Model: fb (6 for a floating base, 0
    for a fixed one), xStdModel, identified_params, Pb, Pd, K, B/Binv
    (when the model uses a basis projection), num_base_params, the
    structural R (Gram), Q, RQ, PQ of its pivoted QR, and gdt (the
    precision its rank threshold assumed)."""
    Q, RQ, PQ = (np.asarray(a) for a in (m.Q, m.R, m.P))
    # the Gram from its pivoted QR: R[:, PQ] = Q @ RQ
    gram = np.empty_like(Q @ RQ)
    gram[:, PQ] = Q @ RQ
    gdt = getattr(m, "_structural_gram_dtype", m._gram_dtype)
    d = dict(
        fb=np.asarray(m.fb),
        xStdModel=np.asarray(m.xStdModel, dtype=float),
        identified_params=np.asarray(m.identified_params, dtype=np.int64),
        Pb=np.asarray(m.Pb), Pd=np.asarray(m.Pd), K=np.asarray(m.K),
        num_base_params=np.asarray(m.num_base_params),
        R=gram, Q=Q, RQ=RQ, PQ=PQ,
        gdt=np.asarray(np.dtype(gdt).name),
    )
    for k in ("B", "Binv"):
        if getattr(m, k, None) is not None:
            d[k] = np.asarray(getattr(m, k))
    return d
