"""What sets the time of the sparse-adaptive forward's kernels A1 and A2 on
the card.

A1 (the dense warm-up, ``adaptive_dense``) is timed with CUDA events
(float32) in the dense-compute regime (n_warmup = L) on u500(8) and
u500(3) (made here by the port's ``sim-draft``, as ``chip_smoke.py``
does), for each number of reads in ``--reads`` (the first B reads at full
length) and each number of deletion-closure rounds in ``--gaps``.  A2 (``adaptive_frontier``, its launch alone after A1's 16 positions) is
timed on ``data/bench``'s frontier with the same reads counts.  One block
walks one read: where the time does not grow with B, the kernel is bound
by one read's chain, not by the card's throughput; the difference
between two round counts is the price of a round.

Usage:
  python dbgphmm_tpu_torch/scripts/adaptive_launch_report.py \
      [--reads 1,30] [--gaps 0,4] [--frontier-len 2500]

Needs a CUDA card and nvcc.  Prints one JSON line per case: the dataset,
n, B, L, n_max_gaps, ms and µs per position, and the card's name and
power limit.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    import numpy as np
    import torch

    import chip_smoke as S
    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import adaptive as AD
    from dbgphmm_tpu_torch.ops.forward import pad_reads, to_device
    from dbgphmm_tpu_torch.phmm.params import PHMMParams

    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", default="1,30")
    ap.add_argument("--gaps", default="0,4")
    ap.add_argument("--frontier-len", type=int, default=S.FRONTIER_LEN)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adaptive_launch_report: needs a CUDA card")
    device = torch.device("cuda")
    card = S.nvidia_smi_line()
    params = PHMMParams.uniform(0.001)  # the CLI's default --p-error
    ratio = params.active_node_max_ratio
    counts = [int(x) for x in args.reads.split(",")]
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        datasets = {}
        for name, n_unit in (("u500(8)", 8), ("u500(3)", 3)):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(S.u500_argv(n_unit, tmp / f"u{n_unit}"))
            datasets[name] = (tmp / f"u{n_unit}.json", tmp / f"u{n_unit}.dbg")
        datasets["data/bench"] = (ROOT / "data/bench/data.json",
                                  ROOT / "data/bench/data.dbg")

        cases = []  # (dataset, kernel, B, gaps)
        for name in ("u500(8)", "u500(3)"):
            for B in counts:
                for G in [int(x) for x in args.gaps.split(",")]:
                    cases.append((name, "A1", B, G))
        cases += [("data/bench", "A2", B, params.n_max_gaps) for B in counts]
        for name, kid, B, G in cases:
            dbg = out.from_dbg_file(datasets[name][1])
            reads = list(Dataset.from_json_file(datasets[name][0]).reads)[:B]
            if kid == "A2":
                reads = [r[:args.frontier_len] for r in reads]
            codes, lens = pad_reads(reads)
            c, l = i32(codes), i32(lens)
            dm = dataclasses.replace(to_device(dbg.to_phmm(
                params, mode="non_zero"), device, torch.float32), n_max_gaps=G)
            n, D = dm.parent_idx.shape
            L = int(c.shape[1])
            kw = TP.sparse_adaptive_args(dbg.n_edges_full(), int(D), L, 128,
                                         torch.float32)
            if kid == "A1":
                run = lambda: AD.forward_sparse_adaptive(
                    dm, c, l, max_ratio=ratio, **kw)
                steps = L
            else:  # A2's launch alone, from a carry A1 made
                f = AD.forward_sparse_adaptive(dm, c, l, max_ratio=ratio, **kw)
                A = min(kw["n_top"] * (int(D) + 1), int(n))
                W = kw["n_warmup"]
                K = int(f.nodes.shape[2])
                tabs = AD.AdaptiveTables(*(torch.empty_like(t) for t in f))
                carry = (torch.empty((B, A), dtype=torch.int32, device=device),
                         *(torch.empty((B, A), device=device) for _ in range(3)),
                         torch.empty((B, 5), device=device))
                lt = torch.stack(list(dm.lt))
                AD.adaptive_dense(dm, lt, c, l, tabs, carry, A, K, W)
                run = lambda: AD.adaptive_frontier(
                    dm, lt, c, l, tabs, carry, A, K, W, kw["n_top"], ratio)
                steps = L - W
            ms = S.cuda_ms(run, args.reps)
            print(json.dumps(dict(
                dataset=name, kernel=kid, n=int(n), D=int(D), B=B, L=L,
                n_max_gaps=G, ms=ms, us_per_position=ms * 1e3 / steps,
                card=card)), flush=True)


if __name__ == "__main__":
    main()
