"""Bar plot of identified-vs-real standard parameter errors.

    python -m flobaroid_tpu_torch.tools.paramErrorPlot IDENTIFIED.urdf \
        REAL.urdf [--out param_errors.png]

The port's copy of tools/paramErrorPlot.py (the reference's
tools/paramErrorPlot.py). Host work only; the plot needs matplotlib."""

from __future__ import annotations

import argparse

import numpy as np

from ..models.urdf import load_urdf


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                prog="python -m flobaroid_tpu_torch.tools.paramErrorPlot")
    p.add_argument("identified_urdf")
    p.add_argument("real_urdf")
    p.add_argument("--out", default="param_errors.png")
    args = p.parse_args(argv)
    pi_id = load_urdf(args.identified_urdf).std_params()
    pi_re = load_urdf(args.real_urdf).std_params()
    err = pi_id - pi_re
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(14, 4), constrained_layout=True)
    ax.bar(range(len(err)), err)
    ax.set_xlabel("standard parameter index")
    ax.set_ylabel("identified - real")
    ax.grid(alpha=0.3)
    fig.savefig(args.out, dpi=120)
    rel = np.linalg.norm(err) / max(np.linalg.norm(pi_re), 1e-12)
    print(f"relative L2 error {rel:.4f}; wrote {args.out}")


if __name__ == "__main__":
    main()
