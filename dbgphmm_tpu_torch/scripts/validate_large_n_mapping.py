"""Validate the mapping regime past DENSE_COMPUTE_MAX_NODES (32,768 full
edges, multi_dbg/posterior.py) at production scale on the port (the
counterpart of scripts/validate_large_n_mapping.py).

Past DENSE_COMPUTE_MAX_NODES, ``generate_mappings`` no longer decodes with
the dense-compute / compact-store decode (exact forward over all n nodes);
with ``DBGPHMM_SEED_MAPPING=0`` it runs the evolving top-K frontier
(``mappings_sparse_adaptive`` with n_top=64).  This script builds the JAX
tool's diploid DBG (500-base unit x 80, 2% divergence; 74,083 full edges
at k=40) and samples its reads with the graph-PHMM sampler from the same
seeds, then measures:

1. per-read log-likelihood gap: the frontier decode (float32, on
   ``--device``) vs the exact dense forward (float64, on ``--device``:
   the oracle, which the JAX tool ran on its host CPU);
2. downstream effect: the mapped-forward score (float32) of the true
   copy numbers and of a perturbed candidate under the frontier mapping,
   against their dense float64 scores: the between-candidate differential
   must match.

Usage: python dbgphmm_tpu_torch/scripts/validate_large_n_mapping.py [--device DEV]

``--device`` defaults to cuda (the script fails without a card); ``cpu``
runs every pass on the host.  Prints the JAX tool's lines, the ``#
VERDICT`` line last, and exits 1 on a disagreement.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

GENOME = dict(unit_size=500, n_unit=80, end_length=300)  # the JAX tool's
READS = dict(n_reads=4, length=4400, min_length=2000)


def main(argv=None, genome=None, reads=None, min_n=None):
    """``genome`` / ``reads`` override GENOME / READS (a smaller run) and
    ``min_n`` the least full-edge count (DENSE_COMPUTE_MAX_NODES)."""
    import torch

    from dbgphmm_tpu_torch.cli import _resolve_device
    from dbgphmm_tpu_torch.multi_dbg import MultiDbg
    from dbgphmm_tpu_torch.multi_dbg.neighbors import to_short_neighbors
    from dbgphmm_tpu_torch.multi_dbg.posterior import DENSE_COMPUTE_MAX_NODES
    from dbgphmm_tpu_torch.ops.adaptive import mappings_sparse_adaptive
    from dbgphmm_tpu_torch.ops.forward import forward_scores, pad_reads, to_device
    from dbgphmm_tpu_torch.ops.sparse import forward_scores_mapped
    from dbgphmm_tpu_torch.phmm.params import PHMMParams
    from dbgphmm_tpu_torch.phmm.sample import (
        SampleProfile,
        sample_positioned_reads_phmm,
    )
    from dbgphmm_tpu_torch.seq import genome as genome_gen

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = _resolve_device(ap.parse_args(argv).device)
    gen = dict(GENOME, **(genome or {}))
    rd = dict(READS, **(reads or {}))
    min_n = DENSE_COMPUTE_MAX_NODES if min_n is None else min_n

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    k = 40
    g = genome_gen.tandem_repeat_polyploid_with_unique_homo_ends(
        gen["unit_size"], gen["n_unit"], 0, 0.02, 1, gen["end_length"], 2,
        0.02, 0
    )
    seqs = [s.seq for s in g]
    print(f"# genome: {len(seqs)} haplotypes, total {g.genome_size()} bp")

    t0 = time.time()
    dbg = MultiDbg.from_styled_seqs(k, list(g))
    n = dbg.n_edges_full()
    print(f"# DBG k={k}: n_full_edges={n} (built in {time.time()-t0:.0f}s)")
    if n <= min_n:
        raise SystemExit(f"need n > {min_n}, got {n}: raise n_unit")

    params = PHMMParams.uniform(0.001)
    model = dbg.to_phmm(params, mode="non_zero")
    dm = to_device(model, device, dtype=torch.float32)

    reads = [
        r.seq
        for r in sample_positioned_reads_phmm(
            seqs, params,
            SampleProfile(n_reads=rd["n_reads"], length=rd["length"], seed=0),
            has_revcomp=False,
        )
        if len(r.seq) >= rd["min_length"]
    ]
    print(f"# {len(reads)} reads, lengths {[len(r) for r in reads]}")
    codes, lens = pad_reads(reads)
    codes_d = torch.as_tensor(codes, device=device)
    lens_d = torch.as_tensor(lens, device=device)

    n_active, max_ratio = 128, 30.0

    # (a) the exact dense score-only forward in float64: the oracle
    t0 = time.time()
    dm64 = to_device(model, device, dtype=torch.float64)
    lp_d = forward_scores(dm64, codes_d, lens_d, renorm=True).cpu().numpy()
    del dm64
    t_dense = time.time() - t0
    print(f"# dense f64 forward ({device.type} oracle): {t_dense:.1f}s "
          f"logp={lp_d[:4].round(1)}")

    # (b) the frontier decode, float32
    t0 = time.time()
    lp_f, mn_f, ml_f = mappings_sparse_adaptive(
        dm, codes_d, lens_d, n_top=64, n_active=n_active,
        max_ratio=max_ratio, n_warmup=16,
    )
    lp_f = lp_f.cpu().numpy()
    del ml_f
    sync()
    t_frontier = time.time() - t0
    print(f"# frontier decode: {t_frontier:.1f}s logp={lp_f[:4].round(1)}")

    gaps = np.abs(lp_f - lp_d[: len(lp_f)])
    print(f"# per-read |logp gap| frontier-decode-vs-dense: "
          f"max={gaps.max():.3f} mean={gaps.mean():.3f}")

    # (c) downstream: two candidates, the truth and a perturbation (the
    # first short neighbour); the mapped likelihood sits a few nats below
    # the dense one (score-ratio trimming sheds mass), but the
    # BETWEEN-CANDIDATE difference under the shared mapping must match
    truth = dbg.get_copy_nums()
    nbrs = to_short_neighbors(dbg, max_cycle_size=10, max_flip=2)
    if not nbrs:
        raise SystemExit("no flow-consistent neighbors found")
    pert = nbrs[0][0]
    deltas = {}
    for name, cn in (("true", truth), ("pert", pert)):
        work = dbg.copy()
        work.set_copy_nums(cn)
        mm = work.to_phmm(params, mode="normal")
        dmn = to_device(mm, device, dtype=torch.float32)
        sc_mapped = forward_scores_mapped(dmn, codes_d, lens_d, mn_f,
                                          renorm=True).cpu().numpy()
        del dmn
        dmn64 = to_device(mm, device, dtype=torch.float64)
        sc_dense = forward_scores(dmn64, codes_d, lens_d,
                                  renorm=True).cpu().numpy()
        del dmn64
        deltas[name] = (sc_mapped, sc_dense)
        gap = np.abs(sc_mapped - sc_dense)
        print(f"# {name}: mapped={sc_mapped.round(1)} dense={sc_dense.round(1)}"
              f" restriction gap max={gap.max():.2f}")
    d_mapped = deltas["true"][0].sum() - deltas["pert"][0].sum()
    d_dense = deltas["true"][1].sum() - deltas["pert"][1].sum()
    print(f"# candidate score DIFFERENTIAL (true - perturbed): "
          f"mapped={d_mapped:.3f} dense={d_dense:.3f} "
          f"|err|={abs(d_mapped - d_dense):.3f}")

    ok = gaps.max() < 1.0 and abs(d_mapped - d_dense) < 1.0 and (
        (d_mapped > 0) == (d_dense > 0)
    )
    print(f"# VERDICT: {'OK' if ok else 'DISAGREEMENT — investigate'}")
    return dict(ok=bool(ok), lp_dense=lp_d, lp_frontier=lp_f,
                dense_s=t_dense, frontier_s=t_frontier, n_full=n,
                lengths=[len(r) for r in reads], d_mapped=float(d_mapped),
                d_dense=float(d_dense),
                true=deltas["true"], pert=deltas["pert"])


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
