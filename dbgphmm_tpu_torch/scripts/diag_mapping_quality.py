"""Walk-consistency of a mapping: a healthy posterior decode's top-1 node
moves src->tgt along graph edges between consecutive read positions.  A
degenerate (absorbed) decode sits on one node or jumps randomly.

For each read: frac_adjacent = fraction of (i, i+1) pairs where top-1(i+1)
is a graph-successor of top-1(i); frac_stuck = fraction where
top-1(i+1) == top-1(i) (self-transitions are legal only at self-loops /
insertions, so a high value = absorption).

Usage: python dbgphmm_tpu_torch/scripts/diag_mapping_quality.py <dbg> <map.mpz>

The counterpart of scripts/diag_mapping_quality.py over the port's
readers (multi_dbg.output); host only.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dbgphmm_tpu_torch.multi_dbg import output as out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dbg = out.from_dbg_file(argv[0])
    maps = out.from_map_file(argv[1])
    src = np.asarray(dbg.full.edge_sources)
    tgt = np.asarray(dbg.full.edge_targets)
    n = dbg.n_edges_full()
    # successor test: tgt[a] == src[b]  (edge b follows edge a)
    rows = []
    for r in range(maps.n_reads()):
        nodes, logps = maps.nodes[r], maps.logps[r]
        if nodes.size == 0:
            rows.append((r, 0, 0.0, 0.0))
            continue
        t1 = np.where(
            (nodes >= 0).any(axis=1),
            nodes[np.arange(nodes.shape[0]), np.argmax(logps, axis=1)],
            -1,
        )
        t1 = t1[t1 >= 0]
        if t1.size < 2:
            rows.append((r, int(t1.size), 0.0, 0.0))
            continue
        a, b = t1[:-1], t1[1:]
        adj = (tgt[a] == src[b]).mean()
        stuck = (a == b).mean()
        rows.append((r, int(t1.size), float(adj), float(stuck)))
    adjs = np.array([x[2] for x in rows])
    stucks = np.array([x[3] for x in rows])
    print(f"# {argv[1]}: {len(rows)} reads")
    print(f"# adjacency: mean {adjs.mean():.3f}  "
          f"n_reads<0.5 {(adjs < 0.5).sum()}  n_reads>0.9 {(adjs > 0.9).sum()}")
    print(f"# stuck:     mean {stucks.mean():.3f}  "
          f"n_reads>0.5 {(stucks > 0.5).sum()}")
    worst = sorted(rows, key=lambda x: x[2])[:8]
    print("# worst reads (r, npos, adj, stuck):",
          [(r, n_, round(a_, 3), round(s_, 3)) for r, n_, a_, s_ in worst])


if __name__ == "__main__":
    main()
