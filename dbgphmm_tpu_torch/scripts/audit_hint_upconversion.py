"""Audit the post-purge hint upconversion (VERDICT r4 item 4).

Since k=43 every post-purge stage gated 98/98 reads — the upconverted
active sets fail the hint-constrained decode.  This script replays the
purge+extend from a per-k checkpoint and measures, against the NEXT k's
from-scratch mapping (the oracle the gate fallback produced), where the
upconverted sets lose the true path:

  * per-read containment: fraction of positions whose oracle top-1 node is
    inside the upconverted hint set
  * empty-row count: positions whose hint lost every candidate
  * width stats (cap truncation suspect: _pad_hint_nodes clips at 2*128)

Usage: python dbgphmm_tpu_torch/scripts/audit_hint_upconversion.py <prefix> <k_from> <k_to>
e.g.   python dbgphmm_tpu_torch/scripts/audit_hint_upconversion.py \
           runs/n5/dbgphmm/pz0.99_pi0.0003 43 44

The counterpart of scripts/audit_hint_upconversion.py over the port's
purge_and_extend_with_posterior (multi_dbg.posterior) and readers; host
only.  The checkpoints' formats are shared, so either package's run
can be audited.
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
    print(f"# k={k_from}: n_full={dbg.n_edges_full()} "
          f"NC={dbg.n_edges_compact()} reads={maps.n_reads()}")

    dbg2, _paths, hint = purge_and_extend_with_posterior(
        dbg, post, k_max=10_000, p0=0.99, paths=None, mappings=maps
    )
    print(f"# purged+extended to k={dbg2.k} "
          f"(n_full={dbg2.n_edges_full()}, NC={dbg2.n_edges_compact()})")
    if dbg2.k != k_to:
        print(f"# WARNING: replay landed on k={dbg2.k}, oracle is k={k_to}")
    if hint is None:
        print("# hint dropped entirely (max_hint_stages)")
        return

    oracle = out.from_map_file(f"{prefix}.k{k_to}.map.mpz")
    n_reads = min(len(hint), oracle.n_reads())
    tot_pos = tot_hit = tot_empty = 0
    per_read = []
    widths = []
    for r in range(n_reads):
        h = np.asarray(hint[r])
        onodes, ologps = oracle.nodes[r], oracle.logps[r]
        L = min(h.shape[0], onodes.shape[0])
        hits = empt = npos = 0
        for i in range(L):
            ov = onodes[i][onodes[i] >= 0]
            if ov.size == 0:
                continue
            top1 = int(onodes[i][np.argmax(ologps[i])])
            hs = h[i][h[i] >= 0]
            npos += 1
            if hs.size == 0:
                empt += 1
            elif top1 in set(hs.tolist()):
                hits += 1
        widths.append(int((h >= 0).sum(axis=1).max(initial=0)))
        per_read.append((hits, empt, npos))
        tot_pos += npos
        tot_hit += hits
        tot_empty += empt
    cont = [h / max(1, n) for h, _e, n in per_read]
    print(f"# containment of oracle top-1 in hint: "
          f"mean {np.mean(cont):.4f} min {np.min(cont):.4f} "
          f"max {np.max(cont):.4f}")
    print(f"# positions: {tot_pos}, hit {tot_hit} "
          f"({tot_hit/max(1,tot_pos):.4f}), empty-hint rows {tot_empty}")
    print(f"# hint widths: median {np.median(widths):.0f} "
          f"max {max(widths)}")
    # where do misses cluster?  show the first read's miss positions
    h = np.asarray(hint[0])
    onodes, ologps = oracle.nodes[0], oracle.logps[0]
    misses = []
    for i in range(min(h.shape[0], onodes.shape[0])):
        ov = onodes[i][onodes[i] >= 0]
        if ov.size == 0:
            continue
        top1 = int(onodes[i][np.argmax(ologps[i])])
        hs = set(h[i][h[i] >= 0].tolist())
        if top1 not in hs:
            misses.append(i)
    print(f"# read 0 miss positions ({len(misses)}): {misses[:40]}")


if __name__ == "__main__":
    main()
