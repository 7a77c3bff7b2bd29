#!/usr/bin/env python
"""Visualize INSPECT files (ref: scripts/visualize_inspect.py in the
reference): per-edge posterior copy numbers vs truth, sample score
distribution, and per-k trajectory when multiple files are given.

Usage: python dbgphmm_tpu_torch/scripts/visualize_inspect.py out.k40.inspect [out.k60.inspect ...] -o plot.png

The counterpart of scripts/visualize_inspect.py over the port's
readers (multi_dbg.output); host only.  matplotlib is imported inside
main(), not with the module, so that the module imports where matplotlib
is not installed (main() then fails on the import).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from dbgphmm_tpu_torch.multi_dbg.output import parse_inspect_file


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("inspect_files", nargs="+")
    ap.add_argument("-o", "--output", default="inspect.png")
    args = ap.parse_args(argv)

    data = [parse_inspect_file(p) for p in args.inspect_files]

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))

    # (1) per-edge posterior mean vs true copy number (last k)
    d = data[-1]
    ax = axes[0]
    means = [e["mean"] for e in d["edges"]]
    trues = [e["copy_num_true"] for e in d["edges"]]
    if any(t is not None for t in trues):
        t = [x if x is not None else np.nan for x in trues]
        ax.scatter(t, means, alpha=0.6)
        lim = max(max(means, default=1), np.nanmax(t) if t else 1) + 0.5
        ax.plot([0, lim], [0, lim], "k--", lw=0.8)
        ax.set_xlabel("true copy number")
    else:
        ax.scatter(range(len(means)), means, alpha=0.6)
        ax.set_xlabel("edge")
    ax.set_ylabel("posterior mean copy number")
    ax.set_title(f"k={d['k']} per-edge posterior")

    # (2) P(X=0) per edge
    ax = axes[1]
    p0 = [e["p_zero"] for e in d["edges"]]
    ax.bar(range(len(p0)), p0)
    ax.set_xlabel("edge")
    ax.set_ylabel("P(X=0 | R)")
    ax.set_title("zero-copy posterior")

    # (3) sample scores per k
    ax = axes[2]
    for d in data:
        scores = [s["likelihood"] + s["prior"] + s["n_euler_circuits"]
                  for s in d["samples"]]
        ax.plot(sorted(scores, reverse=True), marker="o", ms=3,
                label=f"k={d['k']}")
    ax.set_xlabel("sample rank")
    ax.set_ylabel("log score")
    ax.legend()
    ax.set_title("posterior samples")

    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
