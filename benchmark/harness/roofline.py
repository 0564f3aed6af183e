"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and
the least time of the work a kernel site needs."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_TF32_FLOP_PER_S = 495e12  # the fastest unit an f32-accurate Gram can use


def gram_bound_s(N: int, B: int, C: int) -> float:
    """Least time of B Grams Y_b^T Y_b of (N, C) float32 blocks: Y read once
    and G written once at the memory rate, or the symmetric product's
    N*B*C*(C+1) FLOP at the TF32 peak, whichever is larger."""
    t_bytes = 4 * (N * B * C + B * C * C) / PEAK_BYTES_PER_S
    t_ops = N * B * C * (C + 1) / PEAK_TF32_FLOP_PER_S
    return max(t_bytes, t_ops)


def chunks(N: int, chunk: int) -> list:
    """Row counts of N samples taken `chunk` at a time."""
    return [min(chunk, N - s) for s in range(0, N, chunk)]
