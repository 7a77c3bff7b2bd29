"""(The counterpart of scripts/diag_hint_relation2.py over the port's
readers and MultiDbg; host only.  Usage:
python dbgphmm_tpu_torch/scripts/diag_hint_relation2.py <prefix> <k_from> <k_to>)

Part 2: verify the replayed purged+extended graph matches the k_to
checkpoint on disk, then diagnose read-level relations more broadly."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dbgphmm_tpu_torch.multi_dbg import output as out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    prefix, k_from, k_to = argv[0], int(argv[1]), int(argv[2])
    dbg = out.from_dbg_file(f"{prefix}.k{k_from}.dbg")
    post = out.from_post_file(f"{prefix}.k{k_from}.post")
    maps = out.from_map_file(f"{prefix}.k{k_from}.map.mpz")
    disk44 = out.from_dbg_file(f"{prefix}.k{k_to}.dbg")

    work = dbg.copy()
    work.set_copy_nums(post.max_copy_nums())
    lp0 = np.log(0.99)
    edges_purge = [
        e for e in range(work.n_edges_compact())
        if work.copy_num_of_edge_in_compact(e) == 0
        and post.p_edge_x(e, 0) > lp0
    ]
    dbg_p, full_map, _cm = work.purge_edges(edges_purge)
    kp1 = dbg_p.to_kp1_dbg()

    print(f"# replay kp1: k={kp1.k} n_full={kp1.n_edges_full()} "
          f"n_nodes={kp1.n_nodes_full()}")
    print(f"# disk  k{k_to}: n_full={disk44.n_edges_full()} "
          f"n_nodes={disk44.n_nodes_full()}")
    if kp1.n_edges_full() == disk44.n_edges_full():
        a = np.asarray(kp1.full.edge_sources)
        b = np.asarray(disk44.full.edge_sources)
        same = np.array_equal(a, b)
        print(f"# edge_sources identical: {same}")
        ka = [kp1.full.edge(e).base for e in range(200)]
        kb = [disk44.full.edge(e).base for e in range(200)]
        print(f"# first-200 edge bases identical: {ka == kb}")

    # read-level: compare k43 oracle top-1 vs k44 oracle top-1 per position
    maps44 = out.from_map_file(f"{prefix}.k{k_to}.map.mpz")
    fm = np.full(dbg.n_edges_full() + 1, -1, dtype=np.int64)
    for old, new in full_map.items():
        fm[old] = -1 if new is None else new
    src = np.asarray(kp1.full.edge_sources)
    tgt = np.asarray(kp1.full.edge_targets)
    for r in range(4):
        v43 = maps.nodes[r]
        l43 = maps.logps[r]
        e44 = maps44.nodes[r]
        l44 = maps44.logps[r]
        L = min(v43.shape[0], e44.shape[0])
        match = tot = 0
        samples = []
        for i in range(5, L - 5):
            if e44[i][e44[i] >= 0].size == 0 or v43[i][v43[i] >= 0].size == 0:
                continue
            t1_44 = int(e44[i][np.argmax(l44[i])])
            t1_43 = int(fm[v43[i][np.argmax(l43[i])]])
            tot += 1
            if int(tgt[t1_44]) == t1_43:
                match += 1
            elif len(samples) < 5:
                samples.append((i, t1_43, t1_44, int(src[t1_44]),
                                int(tgt[t1_44])))
        print(f"read {r}: tgt(k44 top1)==k43 top1 at {match}/{tot} pos; "
              f"mismatch samples {samples}")


if __name__ == "__main__":
    main()
