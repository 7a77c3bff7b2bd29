"""Throughput benchmark of the port on one GPU (``speed-test``).

Counterpart of the repo-root ``bench.py`` (which imports JAX), with its
three measurements at its shapes:

* the synthetic K1 scorer: a k=10k-scale chain (n = 100k PHMM states,
  D = 2), 100 reads of 10 kb mapped to A = 40 consecutive nodes per base,
  120 compact edges, 64 distinct candidates, each +1/+2 on 4 random
  compact edges (up-only, so every read stays finite), scored by K1 through
  ``MappedScorer(space="packed")``; candidate-read scorings per second;
* the fwd-bwd decode: ``mappings_sparse_adaptive`` on the same chain, the
  reads tiled to B = 384, n_top = n_active = 64, n_warmup = 16, stored_k =
  64, bfloat16 stored tables; reads per second;
* the real-graph K1 scorer, the headline: ``data/bench`` (the k=40 draft
  of the 85 kb flagship genome, 98 reads), its seeded mapping,
  ``PHMMParams.uniform(0.0003)``, the draft's copy numbers and 255
  candidates with +1 on 4 random compact edges; scorings per second.

Each part runs once to warm up and once timed; the timed window starts and
ends with ``torch.cuda.synchronize()`` and holds the copy of the result to
the host.  Each prints one JSON line (the repo-root bench's fields
``metric``, ``value``, ``unit``, ``vs_baseline`` against the same baseline,
plus the device and, on a GPU, its name and power limit as ``nvidia-smi``
prints them); the headline comes last.  A part launches its kernel or
raises: there is no fallback and nothing is written to disk.

    python -m dbgphmm_tpu_torch speed-test            # the GPU, full shapes
    python -c 'from dbgphmm_tpu_torch import bench; bench.main(
        device="cpu", n=2000, B=4, L=200, A=8, C=4, fb_B=8, fb_L=100,
        real_reads=2, real_len=300, real_cands=4)'   # toy shapes, the twins
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# the repo-root bench's baseline: the reference's sparse forward takes ~0.3 s
# per 1 kb read on one core, so ~0.33 reads/s for a 10 kb read
BASELINE_READS_PER_SEC = 1.0 / (0.3 * 10)
DATA = Path(__file__).resolve().parent.parent / "data" / "bench"


def card(device: torch.device) -> dict:
    """The device a line was measured on: on a GPU also its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if device.type != "cuda":
        return {"device": device.type}
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = res.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"device": device.type, "gpu": name, "power_limit": limit}


def timed(device: torch.device, fn):
    """(seconds, result) of one call of ``fn`` after one warm-up call; the
    device is synchronised at both ends of the window, and ``fn`` copies its
    result to the host inside it."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def line(metric: str, value: float, unit: str, dev: dict) -> dict:
    if not (np.isfinite(value) and value > 0):
        raise RuntimeError(f"{metric}: {value}")
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": value / BASELINE_READS_PER_SEC, **dev}


def synthetic_inputs(n: int, D: int, B: int, L: int, A: int, C: int, NC: int):
    """The repo-root bench's synthetic case, from the same seeds in the same
    order: emission, parent arrays, reads (codes, lens), the mapped nodes
    [B, L, A] (A consecutive chain nodes per base from a random start), the
    compact edge of each node and C up-only candidates."""
    rng = np.random.default_rng(0)
    parent_idx = np.zeros((n, D), dtype=np.int32)
    parent_logt = np.full((n, D), -np.inf)
    parent_idx[:, 0] = np.maximum(np.arange(n) - 1, 0)
    parent_logt[:, 0] = 0.0
    emission = rng.integers(0, 4, n).astype(np.uint8)
    codes = rng.integers(0, 4, (B, L)).astype(np.int32)
    lens = np.full(B, L, dtype=np.int32)
    start = rng.integers(0, n - L - A, B)
    map_nodes = (start[:, None, None] + np.arange(L)[None, :, None]
                 + np.arange(A)[None, None, :]).astype(np.int32)
    f2c = (np.arange(n) * NC // n).astype(np.int32)
    cand_rng = np.random.default_rng(1)
    cands = []
    for _ in range(C):
        cn = np.ones(NC, dtype=np.int64)
        bump = cand_rng.choice(NC, size=4, replace=False)
        cn[bump] += cand_rng.integers(1, 3, size=4)
        cands.append(cn.tolist())
    return dict(emission=emission, parent_idx=parent_idx,
                parent_logt=parent_logt, codes=codes, lens=lens,
                map_nodes=map_nodes, full_to_compact=f2c, cands=cands)


def synthetic_template(x: dict, params):
    """The chain's PHMMTemplate, built by hand as the repo-root bench does:
    node i's parent is i - 1 and its child i + 1."""
    from .phmm.template import PHMMTemplate

    n, D = x["parent_idx"].shape
    parent_exists = np.zeros((n, D), dtype=bool)
    parent_exists[1:, 0] = True
    child_idx = np.zeros((n, D), dtype=np.int32)
    child_exists = np.zeros((n, D), dtype=bool)
    child_idx[:, 0] = np.minimum(np.arange(n) + 1, n - 1)
    child_exists[:-1, 0] = True
    return PHMMTemplate(
        params=params, emission=x["emission"], emittable=np.ones(n, bool),
        src_node=np.arange(n, dtype=np.int32),
        full_to_compact=x["full_to_compact"], parent_idx=x["parent_idx"],
        parent_exists=parent_exists, child_idx=child_idx,
        child_exists=child_exists, n_nodes_graph=n)


def run_synthetic(device, x: dict, dev: dict) -> dict:
    """K1 on the synthetic chain: C x B scorings per second."""
    from .ops.mapped_scorer import MappedScorer
    from .ops.sparse import precompute_positions
    from .phmm.params import PHMMParams

    params = PHMMParams.uniform(0.001)
    tpl = synthetic_template(x, params)
    pos = precompute_positions(x["map_nodes"], tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    scorer = MappedScorer(tpl, pos, x["codes"], x["lens"], params, device,
                          space="packed")
    cands = x["cands"]
    dt, out = timed(device, lambda: scorer.per_read(cands))
    if not np.isfinite(out).all():
        raise RuntimeError("synthetic K1: a non-finite read score")
    B, L = x["codes"].shape
    n, A = x["parent_idx"].shape[0], x["map_nodes"].shape[2]
    kernel = "K1 kernel" if device.type == "cuda" else "K1 float64 twin"
    return line("torch_mapped_forward_k1_scorings_per_sec_k10k",
                len(cands) * B / dt,
                f"{L}-base read scorings/s (n={n} states, A={A}, "
                f"C={len(cands)} candidates x B={B} reads, {kernel})", dev)


def run_fwd_bwd(device, x: dict, fb_B: int, fb_L: int, dev: dict) -> dict:
    """The sparse-adaptive forward-backward decode of the chain's reads,
    tiled to ``fb_B`` reads of ``fb_L`` bases: reads per second.  The model
    is the repo-root bench's (its child arrays repeat the parent arrays)."""
    from .ops.adaptive import mappings_sparse_adaptive
    from .ops.forward import to_device
    from .phmm.model import PHMMModel
    from .phmm.params import PHMMParams

    n = x["parent_idx"].shape[0]
    model = PHMMModel(PHMMParams.uniform(0.001), x["emission"],
                      np.full(n, -np.log(n)), x["parent_idx"],
                      x["parent_logt"], x["parent_idx"].copy(),
                      x["parent_logt"].copy())
    dm = to_device(model, device)
    reps = -(-fb_B // x["codes"].shape[0])
    codes = np.concatenate([x["codes"][:, :fb_L]] * reps, axis=0)[:fb_B]
    fb_L = codes.shape[1]
    lens = np.minimum(np.concatenate([x["lens"]] * reps)[:fb_B], fb_L)
    codes_d = torch.as_tensor(codes, device=device)
    lens_d = torch.as_tensor(lens, device=device)
    kw = dict(n_top=64, n_active=64, max_ratio=30.0, n_warmup=16,
              stored_k=64, store_bf16=True)
    dt, logp = timed(device, lambda: mappings_sparse_adaptive(
        dm, codes_d, lens_d, **kw)[0].cpu().numpy())
    if not np.isfinite(logp).all():
        raise RuntimeError("fwd-bwd decode: a non-finite read likelihood")
    return line("torch_fwd_bwd_mapping_reads_per_sec_k10k", fb_B / dt,
                f"{fb_L}-base read fwd-bwd decodes/s (n={n} states, "
                f"sparse-adaptive, n_top=64, B={fb_B}, bf16 compact-stored "
                f"tables)", dev)


def run_real_graph(device, dev: dict, n_reads=None, read_len=None,
                   n_cands: int = 256) -> dict:
    """K1 on ``data/bench``: the seeded mapping of its first ``n_reads``
    reads (all by default; each cut to ``read_len`` bases if given), the
    draft's copy numbers and ``n_cands`` - 1 candidates with +1 on 4 random
    compact edges; candidates x reads per second."""
    from .e2e import Dataset
    from .multi_dbg import output as out
    from .multi_dbg.posterior import Mappings
    from .multi_dbg.seed import seed_mappings_arrays
    from .ops.forward import pad_reads
    from .ops.mapped_scorer import MappedScorer
    from .ops.sparse import pad_mappings, precompute_positions
    from .phmm.params import PHMMParams
    from .phmm.template import make_template

    ds = Dataset.from_json_file(str(DATA / "data.json"))
    reads = [r[:read_len] for r in list(ds.reads)[:n_reads]]
    dbg = out.from_dbg_file(str(DATA / "data.dbg"))
    params = PHMMParams.uniform(0.0003)
    arrs = seed_mappings_arrays(dbg, reads)
    maps = Mappings(arrs, [np.zeros(a.shape) for a in arrs])
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, params)
    W = max(a.shape[1] for a in arrs)
    pos = precompute_positions(pad_mappings(maps, codes.shape[1], W),
                               tpl.parent_idx, parent_exists=tpl.parent_exists)
    scorer = MappedScorer(tpl, pos, codes, lens, tpl.params, device,
                          space="packed")
    NC = dbg.n_edges_compact()
    base = np.asarray(dbg.get_copy_nums(), dtype=np.int64)
    rng = np.random.default_rng(7)
    cands = [base.tolist()]
    for _ in range(n_cands - 1):
        cn = base.copy()
        cn[rng.choice(NC, 4, replace=False)] += 1
        cands.append(cn.tolist())
    dt, (sums, _ok) = timed(device, lambda: scorer.scores_detailed(cands))
    if not np.isfinite(sums[0]):
        raise RuntimeError("real-graph K1: the draft's score is not finite")
    kernel = "K1 kernel" if device.type == "cuda" else "K1 float64 twin"
    return line("torch_real_graph_k1_scorings_per_sec_k40",
                len(cands) * len(reads) / dt,
                f"read scorings/s (data/bench k=40 draft: n={dbg.n_edges_full()}"
                f" full edges, NC={NC}, seeded mapping width {W}, "
                f"C={len(cands)} distinct candidates x {len(reads)} reads of "
                f"up to {int(lens.max())} bases, {kernel})", dev)


def main(device="cuda", n: int = 100_000, D: int = 2, B: int = 100,
         L: int = 10_000, A: int = 40, C: int = 64, NC: int = 120,
         fb_B: int = 384, fb_L: int = None, real_reads: int = None,
         real_len: int = None, real_cands: int = 256):
    """The three measurements at the repo-root bench's shapes (the
    keywords cut them); each line is printed as JSON, the synthetic and
    fwd-bwd lines first and the real-graph headline last.  Returns the
    three lines."""
    device = torch.device(device)
    dev = card(device)
    x = synthetic_inputs(n, D, B, L, A, C, NC)
    lines = []
    for part in (lambda: run_synthetic(device, x, dev),
                 lambda: run_fwd_bwd(device, x, fb_B, fb_L or L, dev),
                 lambda: run_real_graph(device, dev, real_reads, real_len,
                                        real_cands)):
        lines.append(part())
        print(json.dumps(lines[-1]), flush=True)
    return lines
