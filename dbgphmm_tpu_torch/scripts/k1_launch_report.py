"""K1's launches on a checkpoint: per read block of the scorer
``bench_real_graph.py`` builds (the same mapping, streams and rescue
candidates), the launch shape the wrapper picks, K1's time on the card
(CUDA events), its bound (``chip_smoke.bound`` on the block's own streams)
and its share of the bound.

Usage:
  python dbgphmm_tpu_torch/scripts/k1_launch_report.py <out.kK.dbg> \
      <dataset.json> [<out.kK.map.mpz>] [--cands=FILE.npz] [--reps N]

Without the ``.map.mpz`` the reads are mapped (``generate_mappings``).

Needs a CUDA card.  Prints one JSON line per read block (C x B, L, A, D,
NC, n_live eff columns, rows per block G, staged positions TP, resident
blocks per SM, ms, bound_ms, bound_by, share_of_bound), the card's name
and power limit, and a total line.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    import numpy as np
    import torch

    import chip_smoke as S
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.scripts.bench_real_graph import parse_args, setup

    argv = sys.argv[1:] if argv is None else list(argv)
    reps = 3
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    pos, cands_file, _dev = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_launch_report: needs a CUDA card")
    device = torch.device("cuda")
    map_path = pos[2] if len(pos) > 2 else None
    dbg, reads, width, scorer, cands = setup(pos[0], pos[1], map_path, device,
                                             cands_file, log=lambda *a: None)
    lt = scorer._lt[0]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    clock = S.sm_clock_hz()
    kw = dict(n_max_gaps=scorer.n_max_gaps)
    tot_ms = tot_bound = 0.0
    for k, s in enumerate(scorer.chunks):
        dev_s = scorer.block_streams(k)
        eff, total = T._eff_matrix(s, np.asarray(cands, dtype=np.float32))
        eff_t = torch.as_tensor(eff, dtype=torch.float32, device=device)
        inv_t = torch.as_tensor(T.log_inv_total(total), dtype=torch.float32,
                                device=device)
        args = (eff_t, inv_t, *dev_s, lt)
        plan = T.launch_plan("K1", eff_t, dev_s[5])
        ms = S.cuda_ms(lambda: T.mapped_scores_log(*args, **kw), reps)
        L, D, B, A = s.prevp.shape
        b = S.bound("K1", len(cands), dev_s, plan.n_live, scorer.n_max_gaps,
                    clock, n_sm)
        tot_ms += ms
        tot_bound += b["bound_ms"]
        print(json.dumps(dict(
            block=k, C=len(cands), B=int(B), L=int(L), A=int(A), D=int(D),
            NC=int(s.nc_pad), n_live=plan.n_live, group=plan.group,
            stage_positions=plan.stage, blocks_per_sm=plan.blocks_per_sm,
            ms=ms, **b, share_of_bound=b["bound_ms"] / ms)), flush=True)
    print(S.nvidia_smi_line())
    print(json.dumps(dict(graph_k=dbg.k, n_full=dbg.n_edges_full(),
                          NC=dbg.n_edges_compact(), reads=len(reads),
                          width=width, candidates=len(cands),
                          blocks=len(scorer.chunks), ms=tot_ms,
                          bound_ms=tot_bound,
                          share_of_bound=tot_bound / tot_ms,
                          launches=T.mapped_scores_log.launches)))


if __name__ == "__main__":
    main()
