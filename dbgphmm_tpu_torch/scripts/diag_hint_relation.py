"""(The counterpart of scripts/diag_hint_relation.py over the port's
readers and MultiDbg; host only.  Usage:
python dbgphmm_tpu_torch/scripts/diag_hint_relation.py <prefix> <k_from> <k_to>)

Diagnose the upconversion relation: for oracle k+1 top-1 edge at base i,
which transform of the k-mapping at which position contains it?

Candidates tested, for pos offsets o in {-1, 0, +1}:
  in-edges of v      (current _hint_kp1_array semantics)
  out-edges of v
where v ranges over the (purge-remapped) k-mapping nodes at base i+o.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dbgphmm_tpu_torch.multi_dbg import output as out
from dbgphmm_tpu_torch.multi_dbg.posterior import purge_and_extend_with_posterior


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    prefix, k_from, k_to = argv[0], int(argv[1]), int(argv[2])
    dbg = out.from_dbg_file(f"{prefix}.k{k_from}.dbg")
    post = out.from_post_file(f"{prefix}.k{k_from}.post")
    maps = out.from_map_file(f"{prefix}.k{k_from}.map.mpz")

    # replicate the purge ONLY (no kp1), keeping the full_map
    work = dbg.copy()
    work.set_copy_nums(post.max_copy_nums())
    edges_purge = []
    lp0 = np.log(0.99)
    for e in range(work.n_edges_compact()):
        if (work.copy_num_of_edge_in_compact(e) == 0
                and post.p_edge_x(e, 0) > lp0):
            edges_purge.append(e)
    dbg_p, full_map, _cm = work.purge_edges(edges_purge)
    kp1 = dbg_p.to_kp1_dbg()
    assert kp1.k == k_to, (kp1.k, k_to)

    fm = np.full(dbg.n_edges_full() + 1, -1, dtype=np.int64)
    for old, new in full_map.items():
        fm[old] = -1 if new is None else new

    oracle = out.from_map_file(f"{prefix}.k{k_to}.map.mpz")

    # full-graph adjacency of the k+1 graph: edge -> (src node, tgt node)
    # where nodes of k+1 graph == full edges of the purged k graph
    src = np.asarray(kp1.full.edge_sources)
    tgt = np.asarray(kp1.full.edge_targets)

    stats = {}
    for r in range(min(6, len(maps.nodes))):
        h = maps.nodes[r]
        onodes, ologps = oracle.nodes[r], oracle.logps[r]
        L = min(h.shape[0], onodes.shape[0])
        cnt = {}
        npos = 0
        for i in range(5, L - 5):
            ov = onodes[i][onodes[i] >= 0]
            if ov.size == 0:
                continue
            e44 = int(onodes[i][np.argmax(ologps[i])])
            npos += 1
            s44, t44 = int(src[e44]), int(tgt[e44])  # nodes == purged k edges
            for o in (-1, 0, 1):
                row = h[i + o]
                vs = set(fm[row[row >= 0]].tolist()) - {-1}
                if t44 in vs:
                    cnt[(o, "in")] = cnt.get((o, "in"), 0) + 1
                if s44 in vs:
                    cnt[(o, "out")] = cnt.get((o, "out"), 0) + 1
        stats[r] = {k: v / max(1, npos) for k, v in cnt.items()}
        print(f"read {r}: npos={npos} " + " ".join(
            f"{k}={v:.3f}" for k, v in sorted(stats[r].items(),
                                              key=lambda kv: -kv[1])
        ))


if __name__ == "__main__":
    main()
