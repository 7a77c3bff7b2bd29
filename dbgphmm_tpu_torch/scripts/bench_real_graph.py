"""Production-graph scoring benchmark of the port (the counterpart of
scripts/bench_real_graph.py).

``speed-test`` measures K1 on a synthetic degree-1 chain; this script runs
the same scorer (``MappedScorer``, space "packed": K1) on a real extended
DBG checkpoint of a production run: real branching (degree up to 5), real
mapping widths, and distinct rescue-style candidate sets.

Usage:
  python dbgphmm_tpu_torch/scripts/bench_real_graph.py <out.kK.dbg> \
      <dataset.json> [<out.kK.map.mpz>] [--cands=FILE.npz] [--device DEV]

Without the ``.map.mpz`` the mappings are generated (``generate_mappings``).
``--cands=FILE.npz`` scores the dumped batch (its ``candidates`` array)
instead of a fresh rescue sweep.  ``--device`` defaults to cuda; on CUDA
the kernel runs, or the script fails; ``--device cpu`` runs K1's float64
twin.  Prints the JAX tool's lines, its JSON record last.  Not carried
over: ``--xla`` (the port has no XLA tier: a scorer launches its kernel or
raises) and the write into the repository's ``bench_extra.json`` (the
record is printed only).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def parse_args(argv):
    """(positional args, cands file or None, device name)."""
    cands_file, device, pos = None, "cuda", []
    it = iter(argv)
    for a in it:
        if a == "--xla":
            raise SystemExit("bench_real_graph: --xla is not ported (the "
                             "port has no XLA scorer tier)")
        if a.startswith("--cands="):
            cands_file = a.split("=", 1)[1]
        elif a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif not a.startswith("--"):
            pos.append(a)
    return pos, cands_file, device


def setup(dbg_path, ds_path, map_path, device, cands_file=None, log=print):
    """(dbg, reads, width, scorer, candidates) as the benchmark scores
    them; ``log`` gets the JAX tool's set-up lines."""
    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg.neighbors import to_rescue_neighbors
    from dbgphmm_tpu_torch.multi_dbg.posterior import generate_mappings
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.mapped_scorer import MappedScorer
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions
    from dbgphmm_tpu_torch.phmm.params import PHMMParams
    from dbgphmm_tpu_torch.phmm.template import make_template

    ds = Dataset.from_json_file(ds_path)
    reads = ds.reads
    dbg = out.from_dbg_file(dbg_path)
    params = PHMMParams.uniform(0.0003)
    log(f"# graph k={dbg.k}: {dbg.n_edges_full()} full edges, "
        f"{dbg.n_edges_compact()} compact, {len(reads)} reads")

    t0 = time.time()
    if map_path:
        mappings = out.from_map_file(map_path)
        log(f"# mappings loaded from {map_path} ({time.time()-t0:.1f}s)")
    else:
        mappings = generate_mappings(dbg, params, reads, device)
        log(f"# mappings generated ({time.time()-t0:.1f}s)")

    codes, lens = pad_reads(list(reads))
    template = make_template(dbg, params)
    width = max((n.shape[1] for n in mappings.nodes if n.size), default=8)
    map_nodes = pad_mappings(mappings, codes.shape[1], width)
    t0 = time.time()
    positions = precompute_positions(
        map_nodes, template.parent_idx, parent_exists=template.parent_exists
    )
    log(f"# positions {time.time()-t0:.1f}s (width={width})")
    t0 = time.time()
    scorer = MappedScorer(template, positions, codes, lens, template.params,
                          device, space="packed")
    log(f"# streams {time.time()-t0:.1f}s "
        f"({len(scorer.chunks)} read chunk(s))")

    if cands_file:
        arr = np.load(cands_file)["candidates"]
        uniq = [c.tolist() for c in arr]
        log(f"# {len(uniq)} candidates from {cands_file}")
    else:
        # rescue-style distinct candidates around the checkpoint copy numbers
        freqs = mappings.to_node_freqs(dbg.n_edges_full())
        coverage = sum(len(r) for r in reads) / max(1, ds.genome_size())
        t0 = time.time()
        resc = to_rescue_neighbors(dbg, freqs, coverage)
        cands = [dbg.get_copy_nums()] + [cn for cn, _i in resc]
        seen, uniq = set(), []
        for cn in cands:
            k = tuple(cn)
            if k not in seen:
                seen.add(k)
                uniq.append(cn)
        log(f"# {len(uniq)} distinct candidates (rescue sweep "
            f"{time.time()-t0:.1f}s)")
    if len(uniq) < 2:
        # perturb copies to still measure distinct-candidate throughput
        rng = np.random.default_rng(0)
        base = np.asarray(dbg.get_copy_nums())
        for s in range(31):
            v = base.copy()
            v[rng.integers(0, len(v), 3)] += 1
            uniq.append(v.tolist())
    return dbg, reads, width, scorer, uniq


def main(argv=None):
    from dbgphmm_tpu_torch.cli import _resolve_device

    pos, cands_file, device = parse_args(
        sys.argv[1:] if argv is None else argv)
    dbg_path, ds_path = pos[0], pos[1]
    map_path = pos[2] if len(pos) > 2 else None
    device = _resolve_device(device)
    dbg, reads, width, scorer, uniq = setup(dbg_path, ds_path, map_path,
                                            device, cands_file)

    # warm-up (the first call builds the kernel)
    t0 = time.time()
    scorer.scores_detailed(uniq)
    print(f"# compile+first batch {time.time()-t0:.1f}s")

    n_rep = 3
    t0 = time.time()
    for _ in range(n_rep):
        sums, ok = scorer.scores_detailed(uniq)
    dt = (time.time() - t0) / n_rep
    thr = len(uniq) * len(reads) / dt
    print(f"# {dt:.2f}s/batch -> {thr:.1f} read-scorings/s "
          f"({len(uniq)} candidates x {len(reads)} reads)")

    rec = {
        "metric": f"real_graph_scorings_per_sec_k{dbg.k}",
        "value": round(thr, 1),
        "unit": f"10kb-read scorings/s (n={dbg.n_edges_full()} full edges, "
                f"NC={dbg.n_edges_compact()}, width={width}, "
                f"C={len(uniq)} distinct rescue candidates)",
        "vs_baseline": round(thr / 0.33, 1),  # the JAX bench's baseline
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
