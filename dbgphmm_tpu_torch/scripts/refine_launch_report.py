"""What sets the time of the refine's kernels R1 and R2 on the card.

On the seeded hint of ``data/bench`` (or another dataset and draft), R1
(``forward_mapped_tables``) and R2 (``decode_from_forward``'s scan,
``decode_tops``) are timed with CUDA events (float32) for each number of
reads in ``--reads`` (the first B reads, each at full length) and each
number of deletion-closure rounds in ``--gaps``.  One block walks one
read: where the time does not grow with B the kernel is bound by the
chain of one read's positions, not by the card's throughput; the
difference between two round counts is the price of a round.

Usage:
  python dbgphmm_tpu_torch/scripts/refine_launch_report.py \
      [--dataset data/bench/data.json] [--dbg data/bench/data.dbg] \
      [--reads 1,16,98] [--gaps 0,4] [--reps 3]

Needs a CUDA card.  Prints one JSON line per (B, n_max_gaps): L (the
longest of the B reads), the hint width, R1 and R2 ms and µs per position
of that read, each with the card's name and power limit.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    import numpy as np
    import torch

    import chip_smoke as S
    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.multi_dbg.seed import seed_mappings_arrays
    from dbgphmm_tpu_torch.ops import adaptive as AD
    from dbgphmm_tpu_torch.ops.forward import pad_reads, to_device
    from dbgphmm_tpu_torch.phmm.params import PHMMParams

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=str(ROOT / "data/bench/data.json"))
    ap.add_argument("--dbg", default=str(ROOT / "data/bench/data.dbg"))
    ap.add_argument("--reads", default="1,16,98")
    ap.add_argument("--gaps", default="0,4")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("refine_launch_report: needs a CUDA card")
    device = torch.device("cuda")
    card = S.nvidia_smi_line()

    params = PHMMParams.uniform(0.001)  # the CLI's default --p-error
    dbg = out.from_dbg_file(args.dbg)
    counts = [int(x) for x in args.reads.split(",")]
    reads = list(Dataset.from_json_file(args.dataset).reads)[:max(counts)]
    seeds = seed_mappings_arrays(dbg, reads)
    codes, lens = pad_reads(reads)
    hint = TP._pad_hint_nodes(
        TP.Mappings(seeds, [np.zeros(a.shape) for a in seeds], None, None, -1),
        codes.shape[1], 2 * TP.MAPPING_WIDTH_CAP)
    dm0 = to_device(dbg.to_phmm(params, mode="non_zero"), device, torch.float32)
    n_active, ratio = TP.MAPPING_WIDTH_CAP, params.active_node_max_ratio
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)
    for gaps in (int(x) for x in args.gaps.split(",")):
        dm = dataclasses.replace(dm0, n_max_gaps=gaps)
        for B in counts:
            c, l, h = i32(codes[:B]), i32(lens[:B]), i32(hint[:B])
            L, A = int(lens[:B].max()), int(h.shape[2])
            f = AD.forward_mapped_tables(dm, c, l, h)
            k = min(n_active, A)
            r1 = S.cuda_ms(lambda: AD.forward_mapped_tables(dm, c, l, h),
                           args.reps)
            r2 = S.cuda_ms(lambda: AD.decode_tops(dm, c, l, f, k, ratio),
                           args.reps)
            print(json.dumps(dict(
                reads=B, L=L, width=A, n_max_gaps=gaps, r1_ms=r1, r2_ms=r2,
                r1_us_per_position=r1 * 1e3 / L,
                r2_us_per_position=r2 * 1e3 / L, card=card)), flush=True)
    print(card)


if __name__ == "__main__":
    main()
