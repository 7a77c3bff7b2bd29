#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbgphmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA GPU

Phases, each printing one JSON line with its wall time; any failure raises
and the script exits non-zero:

1. device     -- a CUDA GPU is present; its name and power limit (nvidia-smi).
2. build      -- builds the three scorer kernels (csrc/mapped_scorer.cu: K1
                 and K2; csrc/mapped_scorer_linear.cu: K3; nvcc, sm_90a), the
                 refine's two scans (csrc/refine.cu: R1 and R2), the
                 sparse-adaptive forward's two (csrc/adaptive.cu: A1 and
                 A2; both sources include csrc/refine_common.cuh) and the
                 four host libraries (csrc/host/*.cpp, g++) from the
                 checkout's sources, one compiler process each, all at
                 once, after deleting any library an earlier run left;
                 prints each kernel instance's ptxas registers and spills
                 (0 spills asserted for the ten R1 / R2 and the eight A1 /
                 A2 instances).
3. infer      -- the port's CLI, ``sim-infer data/bench/data.json -d
                 data/bench/data.dbg -K 40 -I 1`` on all 98 reads (one
                 k-stage and the final full-neighbourhood pass; cut from
                 -K 41 to keep the smoke inside its time limit), in this
                 process so that the launch counters can be read: the K1
                 kernel ran, no twin did, no likelihood is NaN, the per-k
                 files exist; K1's launches in each stage; every stage's
                 seeded refine launched R1 and R2 (their launches per
                 mapping), no plain version ran.
   mapping    -- the seeded + refined mapping of all 98 reads of the draft
                 that infer's first k-stage computed on the GPU (params of
                 the CLI's default --p-error; one read chunk: R1 and R2
                 once each), shared by the phases below.
   refine_parity -- R1 and R2 against their plain versions run on the card,
                 on the seeded hint that mapping was refined from, for
                 PARITY_READS reads cut to their first PARITY_L positions:
                 in float64 R1's e and R2's map_logp to 1e-9 relative, the
                 stored nodes and the -inf patterns equal, finite m / i / d
                 to 1e-9; in float32 e and map_logp to 1e-5 (map_logp
                 relative to max(|x|, |e of its read|, 1): it is F + B +
                 offsets - log P(read), rounded like terms of that size);
                 >= 99.9% equal top-1 nodes; R2 again on the frontier
                 forward's bfloat16 tables.  R1 and R2 timed (float32, CUDA
                 events) on all 98 reads at full length, beside their bound
                 (refine_bound()), its share, and the plain versions' ms at
                 the cut and at the full shape.
   adaptive_parity -- A1 and A2 against their plain version
                 (forward_sparse_adaptive_reference) run on the card, with
                 generate_mappings' settings: the dense-compute regime
                 (n_warmup = L, A1 alone) on u500(8)'s first ADAPTIVE_READS
                 reads cut to ADAPTIVE_L positions, and the evolving
                 frontier (A1 for 16 positions, then A2; stored_k cells,
                 bfloat16 in float32) on data/bench's first FRONTIER_READS
                 reads cut to FRONTIER_LEN: in float64 the stored nodes
                 and -inf patterns equal, m / i / d, off and e to 1e-9
                 relative; in float32 e to 1e-5 and the tables (bfloat16
                 rows too) bit for bit; R2's decode of both tables >= 99.9%
                 equal top-1 nodes.  Then the main shapes (float32): A1 on
                 all 30 u500(8) reads at full length, A2 at the frontier
                 case; the plain version runs once there, timed, and both
                 kernels' tables are held to it by the same float32 gates.
                 A1 and A2 timed (CUDA events) beside their bound
                 (adaptive_bound(); A2's cell-steps counted in the plain
                 version's run), its share and the plain version's ms.
4. k1_parity  -- K1 against its plain PyTorch twin run on the card in
                 float64: a real case (16 reads of the draft at full length,
                 the draft's copy numbers + 15 rescue candidates, NC trimmed
                 as in production; one candidate per block), the main path's
                 launch shape (the draft's whole neighbourhood, ~2,980
                 candidates, on the same reads: several candidates per block
                 and a partial last group), and synthetic cases at A = 16, 64, 128
                 (D = 3, several 128-wide eff chunks, 21 candidates at 1 and 8
                 per block, SYNTH_L positions); one float64 twin call on the main path's
                 shape serves the real case too (its first rows).  Per
                 read |kernel - twin| <= 1e-5 |twin| + 0.05
                 nats (float32 over a 10 kb read: ~7 barrier-separated
                 rounds per base, each rounding ~6e-8 of a renormalised value
                 of magnitude ~10, plus the Kahan-summed offset), -inf exactly
                 where the twin has it, and the same best candidate; the real
                 case's rows of the large batch equal the real case bit for
                 bit.  The kernel table's ms / plain_ms are the kernel and
                 the float32 twin at the main path's shape; the phase also
                 prints K1's ptxas report, its bound at that shape (see
                 bound()) and its share of it.
5. k2_parity, k3_parity -- K2 and K3 on the real case plus one neighbour
                 that zeroes a compact edge those reads cross (the blocked
                 candidate), and on the synthetic cases (at the picked rows
                 per block and at MAX_ROWS), against their float64 twins
                 with K1's tolerance and the same best candidate.  K2: -inf
                 exactly where the twin has it.  K3: every read that is
                 -inf in float64 is -inf in the kernel, not the converse
                 (float32 underflows ~11 bases into a copy-0 stretch,
                 float64 only after ~90).  At the main path's shape the
                 float64 twin is not run again: K2, and K3 where finite,
                 are held against the K1 output k1_parity checked, and the
                 real case's rows of that batch (several rows per block)
                 equal the real case's launch bit for bit; one float32-twin
                 call there gives plain_ms, and its real-case rows the
                 float32 -inf pattern and max difference.  Each phase prints
                 the launches' rows per block, staged positions and
                 resident blocks per SM, and the ptxas registers and spills
                 of each of the kernel's instances (0 spills asserted).
                 k2_parity also times K2 at one row per block and K1 at
                 K2's rows per block on the main shape, and K2 at the
                 rescue's shape (the draft and its rescue neighbours, all
                 98 reads).  K3's blocked candidate goes through
                 score_candidates with a linear scorer, which must rescue
                 it through K2.
6. refine     -- the first 4 reads' mappings from ``mapping`` (GPU, float32:
                 R1 and R2) against the child's seeded + refined CPU ones
                 (float64, the plain versions): read log-likelihoods to 1e-4
                 relative, >= 99% of positions with the same top-1 node.
7. scorer_spaces -- sample_posterior(max_iter=1) on all 98 reads with the
                 shared mapping, once per scorer space ("packed" K1, "log"
                 K2, "linear" K3 with the rescue): the same accepted move and
                 max_copy_nums, per-sample likelihoods within the summed
                 per-read tolerance; each space launches its kernel and no
                 twin; score seconds, scorings/s and candidates rescued.
8. inspect    -- the port's CLI, ``inspect -d u3.dbg u3.json`` on u500(3)
                 (phase 9's dataset; the smaller graph keeps the smoke
                 inside its time limit), in this process: K2 ran, no twin did, and the
                 orig and true likelihoods agree with a K1 scoring of the
                 same two candidates on the CLI's mapping.
9. dense_decode, adaptive_decode -- the two u500 datasets (tandem repeat
                 of 3 / 8 units of 500 bases, diploid, 15x full-length
                 reads, k=40 draft), made by the port's ``sim-draft`` right
                 after the build (``datasets``): generate_mappings from
                 scratch on the GPU for all reads.  u500(3) (3,567 full
                 edges) must take the dense decode, u500(8) (8,358) the
                 dense-compute sparse-adaptive one (n_warmup = L: A1, then
                 R2, each launched once per call; the dense decode
                 launches none of R1, R2, A1, A2); the first 4 reads' result
                 against the CPU's float64 decode
                 (read log-likelihoods to 1e-4 relative, >= 99% equal
                 top-1 nodes); decode seconds, seconds per read base, the
                 dense read chunk and its forward tables' bytes.
    batch      -- right after dense_decode, on u500(3): batch scoring
                 (ops.batch.candidate_log_likelihoods, the draft's copy
                 numbers and three neighbours stacked, dense and over the
                 GPU's dense decode) on the first 4 reads in float32
                 against float64 on the card to 1e-4 relative;
                 sample_posterior(mappings=None, max_iter=1) on them
                 through BatchScorer, with no scorer kernel or twin
                 launched; the CLI's ``table`` (float64 on the card) on all
                 reads against the CPU's float64 forward of the first read
                 and the float64 batch score of the draft, to 1e-9.
10. frontier_decode -- DBGPHMM_SEED_MAPPING=0 on 4 reads of data/bench
                 (43,743 full edges), each cut to its first FRONTIER_LEN
                 bases (the decode is bound by its per-position launches,
                 so its time follows the cut): the evolving-frontier decode
                 (n_warmup 16, bfloat16 stored tables: A1, A2, then R2,
                 once per call); the same gates on the first read.
11. small_infer -- the CLI's ``sim-infer -K 41 -I 1`` on u500(8), in this
                 process: K1 ran, no twin did, no likelihood is NaN, the
                 per-k files exist; every mapping not refined from a hint
                 launched A1; the stage lines with decode_s and the
                 ``# assembled=`` line.
12. speed_test -- the benchmark (``dbgphmm_tpu_torch.bench.main``, what
                 ``speed-test`` runs) in this process: the synthetic and the
                 real-graph K1 parts at its full shapes, the fwd-bwd decode
                 at its B = 384 reads cut to SPEED_FB_L bases (the full
                 length runs in ``speed-test`` itself); K1 launched in both
                 scorer parts, A1, A2 and R2 in the fwd-bwd part, no twin
                 ran, every
                 value finite and
                 positive; the three lines as the benchmark prints them.

13. mesh_scorer -- right after k3_parity: K1, K2 and K3 through
                 ``MappedScorer(mesh=)`` on a 2x2 mesh whose four shards
                 all name the card, at the parity phases' main shape, held
                 per read to the unsharded launches those phases made (0
                 difference expected, the kernel gate the most allowed),
                 launches = shards x read chunks, no twin; ms of the
                 sharded and the unsharded (no mesh: the 1x1 mesh)
                 scorer's per_read.
14. mesh_path  -- right after batch: generate_mappings(mesh=1x2) on
                 u500(3)'s first MESH_DECODE_READS reads against the same
                 reads of dense_decode's unsharded decode (<= 1e-6
                 relative, >= 99.9% equal top-1 nodes); the seeded refine
                 with mesh=1x2 on data/bench's first MESH_DECODE_READS reads
                 against infer's mapping of them (the same gates; R1 and R2
                 launched shards x read chunks times); sample_posterior(
                 mesh=2x2, max_iter=1) on data/bench with the shared
                 mapping against scorer_spaces' packed posterior (the same
                 samples and max_copy_nums, likelihoods to 1e-5
                 relative); ``dryrun.dryrun_multichip(4)`` on four copies
                 of the card.
15. dist       -- the CLI's ``sample`` on tests/test_multihost.py's toy
                 (12 reads) in two ranks sharing the card (``--dist
                 localhost:P,2,i --mesh 1x2``, gloo; child processes that
                 print their scorer launches) and once alone: both ranks
                 exit 0, each launched K1 (8 and 4 reads) and no twin,
                 each rank's .post equals the single run's.

16. tools      -- right after small_infer: each of the port's tools
                 (dbgphmm_tpu_torch/scripts/, the JAX repo's scripts/) once
                 on files the earlier phases wrote (infer's and small_infer's
                 outputs and logs stay in the run's temporary directory):
                 perk_budget, bench_real_graph on infer's k=40 checkpoint
                 (K1 launched and no twin, counted around the tool alone;
                 then 8 of its candidates on its streams' first
                 TOOLS_TWIN_L positions held to the float64 twin on the
                 card with K1's tolerance), diag_mapping_quality,
                 audit_hint_upconversion and the two diag_hint_relation
                 tools on small_infer's k=40 -> 41, dbgviz,
                 visualize_inspect (where matplotlib is installed), and
                 validate_large_n_mapping at 74,083 full edges on reads cut
                 to 600 bases (its VERDICT line OK).

The CPU float64 mappings of phases 6, 9 and 10 and the batch phase's
float64 score run in a child process (this script with
``--cpu-reference``, 4 threads), started after ``datasets`` and joined by
the phases that read them.  Each path's launch counters are set to 0 just
before it runs and read just after.  Then, on lines of their
own: the card's name and power limit as nvidia-smi prints them, the kernel
table ({"kernels": [...]}: K1, K2, K3, R1, R2, A1, A2; K1's and A1's
launches are small_infer's, R1's and R2's infer's, A2's speed_test's
fwd-bwd part's), and last {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PALLAS = "dbgphmm_tpu/ops/pallas_mapped.py"
SCORER, REFINE = "mapped_scorer", "adaptive"  # modules of dbgphmm_tpu_torch.ops
KERNELS = {  # id: (module, wrapper, source, the TPU kernel or scan it replaces)
    "K1": (SCORER, "mapped_scores_log", "dbgphmm_tpu_torch/csrc/mapped_scorer.cu",
           f"{PALLAS}:718"),  # _make_kernel_log_packed
    "K2": (SCORER, "mapped_scores_log_single",
           "dbgphmm_tpu_torch/csrc/mapped_scorer.cu",
           f"{PALLAS}:488"),  # _make_kernel_log
    "K3": (SCORER, "mapped_scores_linear",
           "dbgphmm_tpu_torch/csrc/mapped_scorer_linear.cu",
           f"{PALLAS}:298"),  # _make_kernel
    # the refine's two lax.scans under jax.jit (XLA, not Pallas)
    "R1": (REFINE, "forward_mapped_tables", "dbgphmm_tpu_torch/csrc/refine.cu",
           "dbgphmm_tpu/ops/adaptive.py:631"),  # forward_mapped_tables
    "R2": (REFINE, "decode_from_forward", "dbgphmm_tpu_torch/csrc/refine.cu",
           "dbgphmm_tpu/ops/adaptive.py:533"),  # _decode_mappings_from_forward
    # the sparse-adaptive forward's two lax.scans (forward_sparse_adaptive)
    "A1": (REFINE, "adaptive_dense", "dbgphmm_tpu_torch/csrc/adaptive.cu",
           "dbgphmm_tpu/ops/adaptive.py:349"),  # the dense warm-up
    "A2": (REFINE, "adaptive_frontier", "dbgphmm_tpu_torch/csrc/adaptive.cu",
           "dbgphmm_tpu/ops/adaptive.py:370"),  # the evolving frontier
}
TWINS = {"K1": "mapped_scores_log_reference",
         "K2": "mapped_scores_log_single_reference",
         "K3": "mapped_scores_linear_reference",
         "R1": "forward_mapped_tables_reference",
         "R2": "decode_from_forward_reference",
         "A1": "forward_sparse_adaptive_reference",
         "A2": "forward_sparse_adaptive_reference"}
REL_TOL, ABS_TOL = 1e-5, 0.05  # per-read kernel vs float64 twin
# positions of the synthetic cases: they vary the slot sets' shapes, not
# the reads' length; their float64 twins are bound by the host's launch
# rate, so their time grows with the positions
SYNTH_L = 500
# the card's peaks (NVIDIA's H100 SXM data sheet)
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s
MUFU_PER_SM_CLK = 16  # exp2 / log2 per SM per clock


def emit(phase, t0, **kv):
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - t0, 3),
                      **kv}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=True):
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call unless ``warmup`` is False."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_fns(kid):
    """(wrapper, plain version) of kernel ``kid``."""
    import importlib

    mod = importlib.import_module(f"dbgphmm_tpu_torch.ops.{KERNELS[kid][0]}")
    return getattr(mod, KERNELS[kid][1]), getattr(mod, TWINS[kid])


def reset_counters():
    for kid in KERNELS:
        wrapper, twin = kernel_fns(kid)
        wrapper.launches = 0
        twin.calls = 0


def read_counters():
    """({kernel id: launches}, {kernel id: twin calls})."""
    fns = {kid: kernel_fns(kid) for kid in KERNELS}
    return ({k: w.launches for k, (w, _t) in fns.items()},
            {k: t.calls for k, (_w, t) in fns.items()})


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def ptxas_of(output):
    """[{entry, registers, spill_stores, spill_loads}] from nvcc -Xptxas -v."""
    import re

    out, entry = [], None
    for ln in output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"log_scorerILi(\d+)ELi(\d+)E", m.group(1))
            lin = re.search(r"linear_scorerILi(\d+)E", m.group(1))
            r1 = re.search(r"refine_forwardI([fd])E", m.group(1))
            r2 = re.search(r"refine_decodeI([fd])(f|d|13__nv_bfloat16)Li(\d)E",
                           m.group(1))
            a12 = re.search(r"adaptive_(dense|frontier)I([fd])(f|d|13__nv_bfloat16)E",
                            m.group(1))
            ty = {"f": "float", "d": "double", "13__nv_bfloat16": "bfloat16"}
            entry = (f"log_scorer<RW={k.group(1)},RENORM={k.group(2)}>" if k
                     else f"linear_scorer<RW={lin.group(1)}>" if lin
                     else f"refine_forward<{ty[r1.group(1)]}>" if r1
                     else (f"refine_decode<{ty[r2.group(1)]},{ty[r2.group(2)]},"
                           f"SPT={r2.group(3)}>") if r2
                     else (f"adaptive_{a12.group(1)}<{ty[a12.group(2)]},"
                           f"{ty[a12.group(3)]}>") if a12
                     else m.group(1))
            out.append({"entry": entry})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def bound(kid, C, dev_s, n_live, n_max_gaps, clock_hz, n_sm):
    """The least time the card could take for one launch of kernel ``kid``
    on these streams (ms) and what sets it.  Counted the same way for K1,
    K2 and K3, from this run's data: per live slot-step (a slot that can
    emit, at a position inside its read; times C candidates) the
    multiply-adds of the scaled-linear recursion (K3's form: 27 + 3 per
    deletion-closure round with one parent column), 2 flops each, plus one
    add (1 flop) per further live parent or out-edge column in each gather;
    for K1 and K2 one exp and one log per M/I/D state (6), for K3 one log
    per read position; the inputs read once and the output written once,
    as the kernel takes them (int32 streams, float32 tables; ``n_live`` eff
    columns, :func:`live_columns` of the launch's table).  Peaks: 67 TFLOP/s
    float32 (an FMA counted as 2 flops), 16 exp2/log2 per SM per clock,
    3.35 TB/s."""
    import torch

    lens, codes, emis, numce, selfp, prevp, curp, dence = dev_s
    L, D, B, A = prevp.shape
    inside = (torch.arange(L, device=lens.device)[:, None] < lens[None, :])
    live = (emis < 4) & inside[:, :, None]  # [L, B, A]
    S = int(live.sum())
    extra = lambda x: int(((x.sum(1) - 1).clamp(min=0) * live).sum())
    flops = (2 * (27 + 3 * n_max_gaps) * S + extra(prevp >= 0)
             + (1 + n_max_gaps) * extra(curp >= 0) + extra(dence < n_live)) * C
    trans = 6 * S * C if kid != "K3" else int(lens.sum()) * C
    stream_bytes = sum(t.numel() * t.element_size() for t in dev_s)
    if kid != "K3":
        stream_bytes += L * B * 4  # the per-position live column count
    nbytes = stream_bytes + C * (int(codes.shape[1]) * 4 + 4) + C * n_live * 4
    times = {"operations": max(flops / PEAK_FP32,
                               trans / (MUFU_PER_SM_CLK * n_sm * clock_hz)),
             "bytes": nbytes / PEAK_HBM}
    by = max(times, key=times.get)
    return dict(bound_ms=times[by] * 1e3, bound_by=by, live_slot_steps=S * C,
                flops=flops, transcendentals=trans, bytes=nbytes,
                flops_ms=flops / PEAK_FP32 * 1e3,
                mufu_ms=trans / (MUFU_PER_SM_CLK * n_sm * clock_hz) * 1e3,
                bytes_ms=times["bytes"] * 1e3)


def check_close(got, ref, what, underflow_ok=False):
    """Per-read tolerance; returns the max abs error over the reads finite
    in both.  With ``underflow_ok`` (K3 in float32 against float64) a read
    may be -inf in ``got`` where ``ref`` is finite, never the converse."""
    import numpy as np

    if np.isnan(got).any():
        raise AssertionError(f"{what}: NaN")
    ninf_g, ninf_r = np.isneginf(got), np.isneginf(ref)
    if underflow_ok:
        if (ninf_r & ~ninf_g).any():
            raise AssertionError(f"{what}: finite where the twin is -inf")
    elif not np.array_equal(ninf_g, ninf_r):
        raise AssertionError(f"{what}: -inf pattern differs from the twin")
    fin = np.isfinite(got) & np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin])
    bad = err > REL_TOL * np.abs(ref[fin]) + ABS_TOL
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} reads beyond tolerance "
                             f"(max |d| {err.max():.4g})")
    return float(err.max(initial=0.0))


def same_best(got, ref, what):
    import numpy as np

    with np.errstate(invalid="ignore"):
        best_k, best_t = int(got.sum(1).argmax()), int(ref.sum(1).argmax())
    assert best_k == best_t, f"{what}: best candidate {best_k} vs {best_t}"


def synthetic_case(A, D, NC, C, B, L, seed, device):
    """Random structurally valid streams: slot ids in [-1, A), compact ids
    in [0, NC) with the NC-1 sentinel, ~20% empty slots."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    emis = rng.integers(0, 4, (L, B, A))
    emis[rng.random((L, B, A)) < 0.2] = 9
    eff = rng.integers(0, 4, (C, NC)).astype(np.float32)
    eff[:, NC - 1] = 0.0
    linv = -np.log(rng.integers(1000, 100000, C).astype(np.float64))
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)
    ints = [i32(a) for a in (
        rng.integers(L // 2, L + 1, B), rng.integers(0, 4, (L, B)), emis,
        rng.integers(0, NC - 1, (L, B, A)), rng.integers(-1, A, (L, B, A)),
        rng.integers(-1, A, (L, D, B, A)), rng.integers(-1, A, (L, D, B, A)),
        rng.integers(0, NC, (L, D, B, A)))]
    return eff, linv, ints


def first_reads(maps, n):
    """The first ``n`` reads' part of a Mappings."""
    from dbgphmm_tpu_torch.multi_dbg.posterior import Mappings

    return Mappings(maps.nodes[:n], maps.logps[:n], maps.read_logps[:n],
                    maps.anchor_logps[:n], maps.stages_since_anchor)


def phase_mapping(params, ds, first):
    """The seeded + refined mapping of all reads of the draft that the
    ``infer`` phase's first k-stage computed (generate_mappings on the
    GPU, the CLI's default --p-error), shared by the phases below."""
    import numpy as np

    t0 = time.perf_counter()
    maps = first["maps"]
    assert first["params"] == params, first["params"]
    assert maps.n_reads() == len(ds.reads)
    assert np.isfinite(maps.read_logps).all()
    # one read chunk (98 <= MAPPING_READ_CHUNK reads): R1 and R2 once each
    n = first["launches"]
    assert n["r1_launches"] == n["r2_launches"] == 1 and not n["twin_calls"], n
    emit("mapping", t0, reads=maps.n_reads(),
         bases=sum(len(r) for r in ds.reads),
         width=max(n.shape[1] for n in maps.nodes),
         hint_width=max(a.shape[1] for a in first["hint"].nodes),
         seed_s=first["seed_s"], refine_s=first["refine_s"], launches=n)
    return maps


PARITY_READS, PARITY_L = 16, 2000  # refine_parity's cut (the plain loops
# are launch-bound: their time follows the positions, not the reads)
BF16_READS, BF16_L = 4, 1000  # R2 on the frontier forward's bfloat16 tables
REFINE_TOL = {"float64": 1e-9, "float32": 1e-5}


def refine_bound(kid, dm, codes, lens, nodes, n_out, clock_hz, n_sm):
    """The least time the card could take for one launch of R1 or R2 on
    these inputs (ms) and what sets it.  Bytes: each input read once (the
    model's arrays the kernel takes, codes, lens, the hint or the stored
    tables) and each output written once (R1: nodes / m / i / d [L, B, A],
    off, e; R2: tops_logp and tops_nodes [L, B, k], k = ``n_out``).
    Operations: the exp / log (log1p) of the recursion per live slot-step
    (a slot holding a node, at a step with a read position), counted from
    this run's data with P the node's finite parent (R1) or child (R2)
    columns, S = P + 1 the cost of a log-sum-exp over them (0 where P = 0)
    and G = n_max_gaps: R1 14 + 2G + (2 + G) S (pre-M and pre-I, M, pre-D,
    the closure's first value and G rounds), R2 10 + 4P + 2G + (3 + G) S
    (D, G rounds, M and I, S and its log);
    at 16 exp2 / log2 per SM per clock (their float32 rate; an accurate
    expf costs more)."""
    import torch

    L, B, A = nodes.shape
    steps = torch.arange(L, device=lens.device)[:, None]
    if kid == "R1":
        live_step = steps < lens[None, :]  # [L, B]
        logt = dm.parent_logt
    else:  # R2's step t holds the stored cells at read position len - 2 - t
        live_step = steps < (lens[None, :] - 1)
        logt = dm.child_logt
    live = (nodes >= 0) & live_step[:, :, None]
    P = torch.isfinite(logt).sum(1)[nodes.clamp(min=0).long()]  # [L, B, A]
    G = dm.n_max_gaps
    S = (P + 1) * (P > 0)
    per = (14 + 2 * G + (2 + G) * S if kid == "R1"
           else 10 + 4 * P + 2 * G + (3 + G) * S)
    trans = int((per * live).sum())
    el = torch.finfo(dm.dtype).bits // 8
    model = sum(t.numel() * t.element_size() for t in (
        (dm.emission, dm.init_logp, dm.parent_idx, dm.parent_logt) if kid == "R1"
        else (dm.emission, dm.child_idx, dm.child_logt)))
    nbytes = model + codes.numel() * 4 + lens.numel() * 4
    if kid == "R1":
        nbytes += L * B * A * 4 + L * B * A * (4 + 3 * el) + L * B * el + B * el
    else:
        nbytes += L * B * A * (4 + 3 * el) + L * B * el + B * el
        nbytes += L * B * n_out * (el + 4)
    times = {"operations": trans / (MUFU_PER_SM_CLK * n_sm * clock_hz),
             "bytes": nbytes / PEAK_HBM}
    by = max(times, key=times.get)
    return dict(bound_ms=times[by] * 1e3, bound_by=by, live_slot_steps=int(live.sum()),
                transcendentals=trans, bytes=nbytes,
                mufu_ms=times["operations"] * 1e3, bytes_ms=times["bytes"] * 1e3)


def rel_err(got, ref, scale=None):
    """max |got - ref| / max(|ref|, |scale|, 1) over the finite entries,
    after asserting the same -inf / +inf pattern; also max |got - ref|.  A
    decode's log posterior is (F + B + offsets) - log P(read): its rounding
    is that of terms as large as the read's log-likelihood, so ``scale`` is
    |e| of its read there."""
    import numpy as np

    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref)), "-inf pattern"
    assert np.array_equal(np.isposinf(got), np.isposinf(ref)), "+inf pattern"
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all(), "NaN"
    den = np.maximum(np.abs(ref), 1.0)
    if scale is not None:
        sc = np.abs(scale.double().cpu().numpy())
        sc = sc.reshape(sc.shape + (1,) * (ref.ndim - sc.ndim))
        den = np.maximum(den, np.where(np.isfinite(sc), sc, 1.0))
    d = np.abs(got[fin] - ref[fin])
    return (float((d / den[fin]).max(initial=0.0)), float(d.max(initial=0.0)))


def top1_agree(got, ref):
    """Share of read positions whose top-1 node is the same, over the
    positions where either has one."""
    g, r = got[..., 0], ref[..., 0]
    has = (g >= 0) | (r >= 0)
    return float((g == r)[has].double().mean()) if bool(has.any()) else 1.0


def phase_refine_parity(device, params, ds, dbg, first):
    """R1 and R2 against their plain versions on the card, on the seeded
    hint the ``infer`` phase's first mapping was refined from: PARITY_READS
    reads cut to their first PARITY_L positions, in float64 (R1's e and
    R2's map_logp to 1e-9 relative, finite m / i / d to 1e-9, the -inf
    patterns and the stored nodes equal) and in float32 (e and map_logp to
    1e-5); R2 on R1's kernel tables against its plain version on the same
    tables; >= 99.9% equal top-1 nodes.  R2 again on the frontier
    forward's bfloat16 tables (BF16_READS reads of BF16_L positions, the
    frontier decode's settings).  Then R1 and R2 (float32) timed with CUDA
    events on all reads at full length, their bound and share of it, and
    the plain versions' ms at the cut and at the full shape."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import adaptive as AD
    from dbgphmm_tpu_torch.ops.forward import pad_reads, to_device

    t0 = time.perf_counter()
    model = dbg.to_phmm(params, mode="non_zero")
    codes, lens = pad_reads(list(ds.reads))
    hint = TP._pad_hint_nodes(first["hint"], codes.shape[1],
                              2 * TP.MAPPING_WIDTH_CAP)
    n_active, ratio = TP.MAPPING_WIDTH_CAP, params.active_node_max_ratio
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)
    cut = (i32(codes[:PARITY_READS, :PARITY_L]),
           i32(np.minimum(lens[:PARITY_READS], PARITY_L)),
           i32(hint[:PARITY_READS, :PARITY_L]))
    full = (i32(codes), i32(lens), i32(hint))
    dms = {name: to_device(model, device, dt) for name, dt in
           (("float64", torch.float64), ("float32", torch.float32))}
    out, err32 = {}, {}
    for name, dm in dms.items():
        tol = REFINE_TOL[name]
        c, l, h = cut
        f = AD.forward_mapped_tables(dm, c, l, h)
        f_ref = AD.forward_mapped_tables_reference(dm, c, l, h)
        assert torch.equal(f.nodes, f_ref.nodes), f"R1 {name}: stored nodes"
        r1 = {k: rel_err(getattr(f, k), getattr(f_ref, k))
              for k in ("e", "m", "i", "d", "off")}
        assert max(v[0] for v in r1.values()) <= tol, (name, r1)
        assert bool(torch.isfinite(f.e).all()), f.e
        got = AD.decode_from_forward(dm, c, l, f, n_active, ratio)
        ref = AD.decode_from_forward_reference(dm, c, l, f, n_active, ratio)
        r2 = rel_err(got[2], ref[2], ref[0])
        agree = top1_agree(got[1], ref[1])
        assert r2[0] <= tol and agree >= 0.999, (name, r2, agree)
        out[name] = dict(r1_rel={k: v[0] for k, v in r1.items()},
                         r2_map_logp_rel=r2[0], r2_top1_agree=agree,
                         r2_nodes_equal=bool(torch.equal(got[1], ref[1])))
        if name == "float32":
            err32 = {"R1": r1["e"][1], "R2": r2[1]}
            cut_ms = dict(
                r1_ms=cuda_ms(lambda: AD.forward_mapped_tables(dm, c, l, h), 3),
                r2_ms=cuda_ms(lambda: AD.decode_tops(
                    dm, c, l, f, min(n_active, h.shape[2]), ratio), 3),
                r1_plain_ms=cuda_ms(lambda: AD.forward_mapped_tables_reference(
                    dm, c, l, h), 1, warmup=False),
                r2_plain_ms=cuda_ms(lambda: AD.decode_from_forward_reference(
                    dm, c, l, f, n_active, ratio), 1, warmup=False))

    # R2 on the frontier forward's bfloat16 tables
    dm = dms["float32"]
    c = i32(codes[:BF16_READS, :BF16_L])
    l = i32(np.minimum(lens[:BF16_READS], BF16_L))
    fb = AD.forward_sparse_adaptive(
        dm, c, l, n_top=TP.ADAPTIVE_FRONTIER_TOP, n_warmup=16, max_ratio=ratio,
        stored_k=max(n_active, TP.ADAPTIVE_FRONTIER_TOP), store_bf16=True)
    assert fb.m.dtype == torch.bfloat16
    got = AD.decode_from_forward(dm, c, l, fb, n_active, ratio)
    ref = AD.decode_from_forward_reference(dm, c, l, fb, n_active, ratio)
    rb = rel_err(got[2], ref[2], ref[0])
    agree = top1_agree(got[1], ref[1])
    assert rb[0] <= REFINE_TOL["float32"] and agree >= 0.999, (rb, agree)
    err32["R2"] = max(err32["R2"], rb[1])
    out["bfloat16_tables"] = dict(reads=BF16_READS, positions=BF16_L,
                                  cells=int(fb.nodes.shape[2]),
                                  r2_map_logp_rel=rb[0], r2_top1_agree=agree)

    # the main shape: all reads at full length, float32
    c, l, h = full
    f = AD.forward_mapped_tables(dm, c, l, h)
    assert bool(torch.isfinite(f.e).all())
    k = min(n_active, h.shape[2])
    ms = {"R1": cuda_ms(lambda: AD.forward_mapped_tables(dm, c, l, h), 3),
          "R2": cuda_ms(lambda: AD.decode_tops(dm, c, l, f, k, ratio), 3)}
    plain = {"R1": cuda_ms(lambda: AD.forward_mapped_tables_reference(
                 dm, c, l, h), 1, warmup=False),
             "R2": cuda_ms(lambda: AD.decode_from_forward_reference(
                 dm, c, l, f, n_active, ratio), 1, warmup=False)}
    clock, n_sm = sm_clock_hz(), torch.cuda.get_device_properties(
        device).multi_processor_count
    res, main = {}, {}
    for kid in ("R1", "R2"):
        bnd = refine_bound(kid, dm, c, l, h.transpose(0, 1) if kid == "R1"
                           else f.nodes, k, clock, n_sm)
        main[kid] = dict(ms=ms[kid], plain_ms=plain[kid], **bnd,
                         share_of_bound=bnd["bound_ms"] / ms[kid])
        res[kid] = dict(max_abs_err=err32[kid], ms=ms[kid], plain_ms=plain[kid],
                        bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    emit("refine_parity", t0, cut=dict(reads=PARITY_READS, positions=PARITY_L,
                                       width=int(cut[2].shape[2]), **cut_ms),
         parity=out, main_shape=dict(reads=int(c.shape[0]), L=int(c.shape[1]),
                                     width=int(h.shape[2]), k=k, **main),
         max_abs_err_f32=err32)
    return res


ADAPTIVE_READS, ADAPTIVE_L = 8, 1000  # adaptive_parity's dense-compute cut


def cell_cost(dm):
    """[n]: the exp / log (log1p) of one cell-step of node j, as for R1
    (refine_bound) plus the ladd3 that ranks the cell (4): 18 + 2G + (2 +
    G) S with S = P + 1 for P finite parent columns (0 where P = 0)."""
    import torch

    G = dm.n_max_gaps
    P = torch.isfinite(dm.parent_logt).sum(1)
    S = (P + 1) * (P > 0)
    return 18 + 2 * G + (2 + G) * S


def frontier_work(dm, run):
    """``run()``, a run of the plain version, with A2's work counted:
    (its result, (live cell-steps, their exp / log)).  A live cell-step is
    a node of a set the frontier steps, at a position inside its read;
    its exp / log are cell_cost's."""
    import torch

    from dbgphmm_tpu_torch.ops import adaptive as AD

    per, step = cell_cost(dm), AD._s_step_attrs
    acc = torch.zeros(2, dtype=torch.int64, device=per.device)

    def counted(dm_, st, cur, attrs, codes, valid):
        live = (cur >= 0) & valid[:, None]
        acc[0] += live.sum()
        acc[1] += (per[cur.clamp(min=0).long()] * live).sum()
        return step(dm_, st, cur, attrs, codes, valid)

    AD._s_step_attrs = counted
    try:
        res = run()
    finally:
        AD._s_step_attrs = step
    return res, tuple(int(x) for x in acc.cpu())


def adaptive_bound(kid, dm, codes, lens, f, A, W, clock_hz, n_sm,
                   frontier_counts=None):
    """The least time the card could take for one launch of A1 or A2 on
    these inputs (ms) and what sets it.  Bytes: each input read once (the
    model's arrays the kernel takes, codes, lens; A2 also A1's carry) and
    each output written once (its rows of the stored tables nodes / m / i
    / d [rows, B, K] in their type, off, e; A1 also the carry [B, A] and
    its scalars).  Operations: the exp / log per live cell-step
    (cell_cost).  A live cell-step of A1 is a node at a position inside
    its read and the warm-up (the dense step computes every node); A2's
    are those of the sets it steps (up to A cells a position), counted by
    frontier_work in a run of the plain version on the same inputs
    (``frontier_counts``)."""
    import torch

    L, B, K = f.nodes.shape
    n = dm.parent_idx.shape[0]
    el = torch.finfo(dm.dtype).bits // 8
    sel = f.m.element_size()
    steps = torch.arange(L, device=lens.device)[:, None]
    inside = steps < lens[None, :]
    live_pos = int((inside & ((steps < W) if kid == "A1" else (steps >= W))).sum())
    if kid == "A1":
        trans = int(cell_cost(dm).sum()) * live_pos
        live = n * live_pos
        rows = W
        model = (dm.emission, dm.init_logp, dm.parent_idx, dm.parent_logt)
    else:
        live, trans = frontier_counts
        rows = L - W
        model = (dm.emission, dm.init_logp, dm.parent_idx, dm.parent_logt,
                 dm.child_idx, dm.child_logt)
    nbytes = sum(t.numel() * t.element_size() for t in model)
    nbytes += codes.numel() * 4 + lens.numel() * 4
    nbytes += B * A * (4 + 3 * el) + 5 * B * el  # the carry
    nbytes += rows * B * K * (4 + 3 * sel) + rows * B * el + B * el
    times = {"operations": trans / (MUFU_PER_SM_CLK * n_sm * clock_hz),
             "bytes": nbytes / PEAK_HBM}
    by = max(times, key=times.get)
    return dict(bound_ms=times[by] * 1e3, bound_by=by, live_cell_steps=live,
                cells_per_step=live / max(live_pos, 1),
                transcendentals=trans, bytes=nbytes,
                mufu_ms=times["operations"] * 1e3, bytes_ms=times["bytes"] * 1e3)


def hold_adaptive(dm, c, l, got, ref, n_active, ratio, what):
    """A1 / A2's tables ``got`` against the plain version's ``ref``: the
    stored nodes and the -inf patterns equal; in float64 m / i / d, off
    and e to 1e-9 relative, in float32 e to 1e-5 and m / i / d (bfloat16
    rows too) and off bit for bit; R2's decode of both: >= 99.9% equal
    top-1 nodes.  Returns (relative errors, top-1 agreement)."""
    import torch

    from dbgphmm_tpu_torch.ops import adaptive as AD

    assert torch.equal(got.nodes, ref.nodes), (what, "stored nodes")
    rel = {k: rel_err(getattr(got, k), getattr(ref, k))[0]
           for k in ("m", "i", "d", "off", "e")}
    if dm.dtype == torch.float64:
        assert max(rel.values()) <= REFINE_TOL["float64"], (what, rel)
    else:
        assert rel["e"] <= REFINE_TOL["float32"], (what, rel)
        for k in ("m", "i", "d", "off"):
            assert torch.equal(getattr(got, k), getattr(ref, k)), (what, k)
    dec = AD.decode_from_forward(dm, c, l, got, n_active, ratio)
    dec_ref = AD.decode_from_forward(dm, c, l, ref, n_active, ratio)
    agree = top1_agree(dec[1], dec_ref[1])
    assert agree >= 0.999, (what, agree)
    return rel, agree


def phase_adaptive_parity(device, params, u8_json, u8_dbg):
    """A1 and A2 against their plain version (forward_sparse_adaptive_
    reference) run on the card, held by hold_adaptive().  The dense-
    compute regime (n_warmup = L: A1 alone) on u500(8)'s first
    ADAPTIVE_READS reads cut to ADAPTIVE_L positions, and the evolving
    frontier (A1 for 16 positions, then A2; stored_k cells, bfloat16 in
    float32) on data/bench's first FRONTIER_READS reads cut to
    FRONTIER_LEN, as generate_mappings sets them, in float64 and float32.
    Then the main shapes in float32: A1 on all 30 u500(8) reads at full
    length (small_infer's and adaptive_decode's launch) and A2 at the
    frontier case's shape (frontier_decode's): the plain version runs
    once there, timed, and the kernels' tables are held to it.  A1 and A2
    timed with CUDA events (A2 its launch alone, after A1's warm-up),
    beside their bounds (adaptive_bound()) and shares, and the plain
    version's ms (A2's: the whole forward, warm-up included)."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import adaptive as AD
    from dbgphmm_tpu_torch.ops.forward import pad_reads, to_device

    t0 = time.perf_counter()
    n_active, ratio = TP.MAPPING_WIDTH_CAP, params.active_node_max_ratio

    def settings(dm, n_full, L):
        """forward_sparse_adaptive's arguments as generate_mappings picks
        them."""
        return dict(max_ratio=ratio, **TP.sparse_adaptive_args(
            n_full, int(dm.parent_idx.shape[1]), L, n_active, dm.dtype))

    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)
    bench = ROOT / "data/bench/data.json", ROOT / "data/bench/data.dbg"
    cases = {"dense_compute": (u8_json, u8_dbg, ADAPTIVE_READS, ADAPTIVE_L, False),
             "frontier": (*bench, FRONTIER_READS, FRONTIER_LEN, True)}
    out_d, err32, full = {}, {"A1": 0.0, "A2": 0.0}, {}
    for name, (js, dbg_path, n_reads, cut, frontier) in cases.items():
        reads = list(Dataset.from_json_file(js).reads)
        dbg = out.from_dbg_file(dbg_path)
        n_full = dbg.n_edges_full()
        assert (n_full > TP.DENSE_COMPUTE_MAX_NODES) == frontier, (name, n_full)
        model = dbg.to_phmm(params, mode="non_zero")
        codes, lens = pad_reads(reads)
        c = i32(codes[:n_reads, :cut])
        l = i32(np.minimum(lens[:n_reads], cut))
        # A1's main shape: every u500(8) read at full length; A2's: the
        # frontier_decode phase's reads
        full[name] = ((n_full, model, c, l) if frontier
                      else (n_full, model, i32(codes), i32(lens)))
        res = {}
        for dt in (torch.float64, torch.float32):
            dm = to_device(model, device, dt)
            kw = settings(dm, n_full, int(c.shape[1]))
            n1, n2 = AD.adaptive_dense.launches, AD.adaptive_frontier.launches
            got = AD.forward_sparse_adaptive(dm, c, l, **kw)
            plain = lambda: AD.forward_sparse_adaptive_reference(dm, c, l, **kw)
            if frontier and dt == torch.float32:  # A2's main shape
                ref, a2_work = frontier_work(dm, plain)
            else:
                ref = plain()
            assert AD.adaptive_dense.launches == n1 + 1
            assert AD.adaptive_frontier.launches == n2 + int(frontier)
            rel, agree = hold_adaptive(dm, c, l, got, ref, n_active, ratio,
                                       (name, str(dt)))
            if dt == torch.float32:
                kid = "A2" if frontier else "A1"
                err32[kid] = max(err32[kid], rel_err(got.e, ref.e)[1])
            res[str(dt).split(".")[1]] = dict(
                rel=rel, top1_agree=agree, cells=int(got.nodes.shape[2]),
                stored=str(got.m.dtype).split(".")[1], **{
                    k: v for k, v in kw.items() if k != "max_ratio"})
        out_d[name] = dict(reads=int(c.shape[0]), positions=int(c.shape[1]),
                           n=int(dm.init_logp.shape[0]),
                           D=int(dm.parent_idx.shape[1]), **res)

    # the main shapes, float32: A1 over all of u500(8) (the dense-compute
    # regime), A2 over the frontier case
    clock, n_sm = sm_clock_hz(), torch.cuda.get_device_properties(
        device).multi_processor_count
    main, resd = {}, {}
    for kid, name in (("A1", "dense_compute"), ("A2", "frontier")):
        n_full, model, c, l = full[name]
        dm = to_device(model, device, torch.float32)
        B, L = c.shape
        kw = settings(dm, n_full, int(L))
        f = AD.forward_sparse_adaptive(dm, c, l, **kw)
        held = {}  # the plain version once: timed and held to
        plain = cuda_ms(lambda: held.setdefault(
            "f", AD.forward_sparse_adaptive_reference(dm, c, l, **kw)), 1,
            warmup=False)
        rel, agree = hold_adaptive(dm, c, l, f, held["f"], n_active, ratio,
                                   (name, "main shape"))
        err32[kid] = max(err32[kid], rel_err(f.e, held["f"].e)[1])
        assert bool(torch.isfinite(f.e).all()), (kid, f.e)
        n, D = dm.parent_idx.shape
        A = min(kw["n_top"] * (D + 1), n)
        K, W = int(f.nodes.shape[2]), min(kw["n_warmup"], L)
        if kid == "A1":
            run = lambda: AD.forward_sparse_adaptive(dm, c, l, **kw)
        else:  # A2's launch alone, from a carry A1 made
            tabs = AD.AdaptiveTables(*(torch.empty_like(t) for t in f))
            carry = (torch.empty((B, A), dtype=torch.int32, device=device),
                     *(torch.empty((B, A), device=device) for _ in range(3)),
                     torch.empty((B, 5), device=device))
            lt = torch.stack(list(dm.lt))
            AD.adaptive_dense(dm, lt, c, l, tabs, carry, A, K, W)
            run = lambda: AD.adaptive_frontier(dm, lt, c, l, tabs, carry, A, K,
                                               W, kw["n_top"], kw["max_ratio"])
        ms = cuda_ms(run, 3)
        bnd = adaptive_bound(kid, dm, c, l, f, A, W, clock, n_sm,
                             frontier_counts=a2_work)
        main[kid] = dict(case=name, reads=int(B), L=int(L), n=int(n), A=A, K=K,
                         W=W, ms=ms, plain_ms=plain, rel=rel, top1_agree=agree,
                         us_per_position=ms * 1e3 / (W if kid == "A1" else L - W),
                         **bnd, share_of_bound=bnd["bound_ms"] / ms)
        resd[kid] = dict(max_abs_err=err32[kid], ms=ms, plain_ms=plain,
                         bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    emit("adaptive_parity", t0, parity=out_d, main_shape=main,
         max_abs_err_f32=err32)
    return resd


def phase_k1_parity(device, params, ds, dbg, maps98):
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.multi_dbg.neighbors import (
        NeighborConfig,
        to_neighbor_copy_nums_and_infos,
        to_rescue_neighbors,
    )
    from dbgphmm_tpu_torch.phmm.template import make_template
    from dbgphmm_tpu_torch.ops import _build
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions

    t0 = time.perf_counter()
    reads = list(ds.reads)[:16]
    B = len(reads)
    maps = first_reads(maps98, B)
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, params)
    width = max(n.shape[1] for n in maps.nodes)
    pos = precompute_positions(pad_mappings(maps, codes.shape[1], width),
                               tpl.parent_idx, parent_exists=tpl.parent_exists)
    scorer = T.MappedScorer(tpl, pos, codes, lens, params, device)
    coverage = sum(len(r) for r in reads) / ds.genome_size()
    rescue = to_rescue_neighbors(dbg, maps.to_node_freqs(dbg.n_edges_full()),
                                 coverage)
    cands = [dbg.get_copy_nums()] + [cn for cn, _i in rescue[:15]]
    assert len(cands) == 16, f"only {len(cands) - 1} rescue candidates"
    assert len(scorer.chunks) == 1
    s, dev_s = scorer.chunks[0], scorer.block_streams(0)
    L, D, _, A = s.prevp.shape
    lt = T.lin_params(params, np.float64)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    kw = dict(n_max_gaps=params.n_max_gaps)

    def k1_args(batch, dt):
        eff, total = T._eff_matrix(s, batch)
        return (on(eff, dt), on(T.log_inv_total(total), dt), *dev_s, on(lt, dt))

    def launch_of(eff):
        """The wrapper's (G, TP) for this eff table."""
        return T.launch_plan("K1", eff, dev_s[5])[:2]

    def parity(got, ref_np, what):
        """The kernel's [C, B] output against the float64 twin's; returns
        the max abs error."""
        got_np = got[:, :B].double().cpu().numpy()
        err = check_close(got_np, ref_np, what)
        same_best(got_np, ref_np, what)
        return err

    # the main path's launch shape: the draft's whole neighbourhood (the
    # final pass's batch) on the same reads, the real case's candidates
    # first.  The wrapper picks G = 8; one candidate is dropped if needed
    # so that the last group is partial (its tail rows recompute the last
    # candidate and are not written).  One float64 twin call holds both
    # the real case (its first rows) and the whole batch.
    seen = {tuple(cn) for cn in cands}
    full = cands + [cn for cn, _i in
                    to_neighbor_copy_nums_and_infos(dbg, NeighborConfig())
                    if tuple(cn) not in seen]
    if len(full) % T.MAX_ROWS == 0:
        full.pop()
    ref_full = T.mapped_scores_log_reference(*k1_args(full, torch.float64),
                                             **kw)[:, :B].cpu().numpy()

    # the real case: 16 candidates x 16 reads (the wrapper picks G = 1)
    args32 = k1_args(cands, torch.float32)
    got = T.mapped_scores_log(*args32, **kw)
    err_real = parity(got, ref_full[:len(cands)], "real case")
    ms_real = cuda_ms(lambda: T.mapped_scores_log(*args32, **kw), 5)
    real = dict(C=len(cands), B=B, L=int(L), A=int(A), D=int(D), NC=s.nc_pad,
                n_live=T.live_columns(args32[0]),
                group_stage=launch_of(args32[0]),
                max_abs_err=err_real, ms=ms_real,
                kernel_scorings_per_s=len(cands) * B / (ms_real / 1e3))

    args_f = k1_args(full, torch.float32)
    n_live = T.live_columns(args_f[0])
    G_full, TP_full = launch_of(args_f[0])
    assert G_full > 1, f"the wrapper picks G={G_full} for the full batch"
    out_f = T.mapped_scores_log(*args_f, **kw)
    err_full = parity(out_f, ref_full, "full batch")
    del ref_full
    got1 = T.mapped_scores_log(*args32, group=1, **kw)
    assert torch.equal(got1, got) and torch.equal(out_f[:len(cands)], got1), \
        f"the real case's rows at G={G_full} differ from G=1"
    ms_f = cuda_ms(lambda: T.mapped_scores_log(*args_f, **kw), 2)
    # the twin compiles nothing and the float64 call above has warmed the
    # allocator: one timed call (each takes tens of seconds)
    twin32 = []
    plain_ms = cuda_ms(
        lambda: twin32.append(T.mapped_scores_log_reference(*args_f, **kw)),
        1, warmup=False)
    diff32 = (out_f - twin32[-1])[:, :B].abs()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    bnd = bound("K1", len(full), dev_s, n_live, params.n_max_gaps,
                sm_clock_hz(), n_sm)
    ptx = [e for e in ptxas_of(_build.BUILD_LOG["libmapped_scorer"]["output"])
           if "RENORM=2" in e["entry"]]
    assert ptx and all(e.get("spill_stores") == 0 for e in ptx), ptx
    batch = dict(C=len(full), B=B, n_live=n_live, group=G_full,
                 stage_positions=TP_full,
                 max_abs_err=err_full, real_case_rows_bit_equal=True, ms=ms_f,
                 plain_ms=plain_ms,
                 max_abs_diff_f32_twin=float(diff32[diff32.isfinite()].max()),
                 kernel_scorings_per_s=len(full) * B / (ms_f / 1e3),
                 **bnd, share_of_bound=bnd["bound_ms"] / ms_f)

    # synthetic: wider slot sets, D = 3, several 128-wide eff chunks; 21
    # candidates at the picked group (G = 1) and forced to G = 8
    synth = []
    err_max = max(err_real, err_full)
    for A_s, NC_s in ((16, 256), (64, 384), (128, 256)):
        eff_s, linv_s, ints = synthetic_case(A_s, 3, NC_s, C=21, B=12, L=SYNTH_L,
                                             seed=A_s, device=device)
        a32 = (on(eff_s, torch.float32), on(linv_s, torch.float32), *ints,
               on(lt, torch.float32))
        r = T.mapped_scores_log_reference(on(eff_s, torch.float64),
                                          on(linv_s, torch.float64), *ints,
                                          on(lt, torch.float64), **kw)
        r_np = r.cpu().numpy()
        case = dict(A=A_s, D=3, NC=NC_s, C=21)
        for g in (None, T.MAX_ROWS):
            o_np = T.mapped_scores_log(*a32, group=g, **kw).double().cpu().numpy()
            e = check_close(o_np, r_np, f"synthetic A={A_s} group={g}")
            same_best(o_np, r_np, f"synthetic A={A_s} group={g}")
            err_max = max(err_max, e)
            case[f"max_abs_err_group_{g or 'picked'}"] = e
        synth.append(case)

    emit("k1_parity", t0, ptxas=ptx, real=real, full_batch=batch,
         synthetic=synth)
    ctx = dict(tpl=tpl, pos=pos, codes=codes, lens=lens, scorer=scorer,
               s=s, dev_s=dev_s, cands=cands, full=full, k1_full=out_f, B=B,
               lt=lt, kw=kw, maps=maps, n_sm=n_sm)
    return dict(max_abs_err=err_max, ms=ms_f, plain_ms=plain_ms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"]), ctx


def blocked_candidate(device, ctx):
    """The neighbour of the main-path batch (past the real case) that forces
    the most of the real case's reads across copy-0 edges: the most reads
    that K3 underflows on (one selecting launch, before any counted path),
    ties broken by the largest per-read drop under K1 against the draft."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    s, B = ctx["s"], ctx["B"]
    eff, total = T._eff_matrix(s, ctx["full"])
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    k3 = T.mapped_scores_linear(on(eff), on(T.lin_inv_total(total)),
                                *ctx["dev_s"], on(ctx["lt"]),
                                **ctx["kw"])[:, :B].cpu().numpy()
    k1 = ctx["k1_full"][:, :B].double().cpu().numpy()
    n0 = len(ctx["cands"])
    n_inf = np.isneginf(k3[n0:]).sum(axis=1)
    drop = (k1[0] - k1[n0:]).max(axis=1)
    i = int(np.lexsort((-drop, -n_inf))[0])
    assert n_inf[i] > 0, "no neighbour forces a read across copy-0 edges"
    return n0 + i


def rescue_shape(device, params, ds, dbg, maps98):
    """The linear rescue's launch on the draft: every read, and the batch
    K3 flags in ``scorer_spaces`` (the draft's copy numbers and its rescue
    neighbours).  Returns (K2's arguments, candidates, reads)."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.multi_dbg.neighbors import to_rescue_neighbors
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions
    from dbgphmm_tpu_torch.phmm.template import make_template

    reads = list(ds.reads)
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, params)
    width = max(n.shape[1] for n in maps98.nodes)
    pos = precompute_positions(pad_mappings(maps98, codes.shape[1], width),
                               tpl.parent_idx, parent_exists=tpl.parent_exists)
    scorer = T.MappedScorer(tpl, pos, codes, lens, params, device)
    assert len(scorer.chunks) == 1
    coverage = sum(len(r) for r in reads) / ds.genome_size()
    rescue = to_rescue_neighbors(dbg, maps98.to_node_freqs(dbg.n_edges_full()),
                                 coverage)
    # as sample_posterior scores them: each assignment once
    cands = list({tuple(cn): list(cn) for cn in
                  [dbg.get_copy_nums()] + [cn for cn, _i in rescue]}.values())
    eff, total = T._eff_matrix(scorer.chunks[0], cands)
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    lt = T.lin_params(params, np.float32)
    args = (on(eff), on(T.log_inv_total(total)), *scorer.block_streams(0),
            torch.as_tensor(lt, device=device))
    return args, len(cands), len(reads)


def phase_parity(kid, device, params, dbg, ctx, genome_size, rescue_args=None):
    """K2 or K3 against its twin on the real case + the blocked candidate,
    the synthetic cases, and K1's output at the main path's shape.  K2
    also at the rescue's shape (``rescue_args``), and the times that tell
    its row grouping from its renormalisation apart."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import _build
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    t0 = time.perf_counter()
    kernel, twin = kernel_fns(kid)
    linear = kid == "K3"
    inv_of = T.lin_inv_total if linear else T.log_inv_total
    s, dev_s, B, lt, kw = (ctx[k] for k in ("s", "dev_s", "B", "lt", "kw"))
    full = ctx["full"]
    i_blk = ctx["blocked"]
    real_idx = list(range(len(ctx["cands"]))) + [i_blk]
    real = [full[i] for i in real_idx]
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)

    def args(batch, dt, inv_of=inv_of):
        eff, total = T._eff_matrix(s, batch)
        return (on(eff, dt), on(inv_of(total), dt), *dev_s, on(lt, dt))

    def kernel_sum(fn, inv_of, cn):
        out = fn(*args([cn], torch.float32, inv_of), **kw)
        return out[0, :B].double().sum().item()

    def plan(a, group=None):
        return T.launch_plan(kid, a[0], a[7], group)._asdict()

    stem = "libmapped_scorer_linear" if linear else "libmapped_scorer"
    ptx = [e for e in ptxas_of(_build.BUILD_LOG[stem]["output"])
           if linear or "RENORM=1" in e["entry"]]
    assert len(ptx) == 3 and all(e.get("spill_stores") == 0 for e in ptx), ptx

    # the real case, 17 candidates x 16 reads, against the float64 twin
    args_r = args(real, torch.float32)
    got_t = kernel(*args_r, **kw)
    got = got_t[:, :B].double().cpu().numpy()
    ref = twin(*args(real, torch.float64), **kw)[:, :B].cpu().numpy()
    err_real = check_close(got, ref, f"{kid} real case", underflow_ok=linear)
    same_best(got, ref, f"{kid} real case")
    real_out = dict(C=len(real), B=B, max_abs_err=err_real, launch=plan(args_r),
                    blocked_reads_neginf=int(np.isneginf(got[-1]).sum()),
                    blocked_reads_neginf_f64_twin=int(np.isneginf(ref[-1]).sum()))
    if linear:
        # float32 linear underflows on the blocked candidate's reads
        assert np.isneginf(got[-1]).any(), "K3 did not flag the blocked candidate"

    # synthetic cases against the float64 twin, at the picked group and at
    # MAX_ROWS candidates per block (21 candidates: a partial last group)
    synth, err_max = [], err_real
    for A_s, NC_s in ((16, 256), (64, 384), (128, 256)):
        eff_s, linv_s, ints = synthetic_case(A_s, 3, NC_s, C=21, B=12, L=SYNTH_L,
                                             seed=A_s, device=device)
        inv_s = np.exp(linv_s) if linear else linv_s
        r_np = twin(on(eff_s, torch.float64), on(inv_s, torch.float64), *ints,
                    on(lt, torch.float64), **kw).cpu().numpy()
        case = dict(A=A_s, D=3, NC=NC_s, C=21)
        a32 = (on(eff_s, torch.float32), on(inv_s, torch.float32), *ints,
               on(lt, torch.float32))
        for g in (None, T.MAX_ROWS):
            o_np = kernel(*a32, group=g, **kw).double().cpu().numpy()
            what = f"{kid} synthetic A={A_s} group={g}"
            e = check_close(o_np, r_np, what, underflow_ok=linear)
            same_best(o_np, r_np, what)
            err_max = max(err_max, e)
            case[f"max_abs_err_group_{g or 'picked'}"] = e
        synth.append(case)

    # the main path's shape: against K1's checked output and the real case
    # bit for bit, then the times
    args_f = args(full, torch.float32)
    launch_f = plan(args_f)
    assert launch_f["group"] > 1, launch_f
    out_f = kernel(*args_f, **kw)
    assert torch.equal(out_f[real_idx], got_t), \
        f"{kid}: the real case's rows at G={launch_f['group']} differ"
    got_f = out_f[:, :B].double().cpu().numpy()
    k1_f = ctx["k1_full"][:, :B].double().cpu().numpy()
    err_k1 = check_close(got_f, k1_f, f"{kid} vs K1 at the main path's shape",
                         underflow_ok=linear)
    ms = cuda_ms(lambda: kernel(*args_f, **kw), 2)
    twin32 = []
    plain_ms = cuda_ms(lambda: twin32.append(twin(*args_f, **kw)), 1,
                       warmup=False)
    t32 = twin32[-1][real_idx, :B].double().cpu().numpy()
    o32 = out_f[real_idx, :B].double().cpu().numpy()
    assert np.array_equal(np.isneginf(o32), np.isneginf(t32)), \
        f"{kid}: -inf pattern differs from the float32 twin"
    fin = np.isfinite(t32)
    bnd = bound(kid, len(full), dev_s, launch_f["n_live"],
                kw["n_max_gaps"], sm_clock_hz(), ctx["n_sm"])
    main = dict(C=len(full), B=B, launch=launch_f, ms=ms, plain_ms=plain_ms,
                **bnd, share_of_bound=bnd["bound_ms"] / ms,
                max_abs_diff_k1=err_k1,
                n_reads_neginf=int(np.isneginf(got_f).sum()),
                max_abs_diff_f32_twin_real_case=float(
                    np.abs(o32[fin] - t32[fin]).max(initial=0.0)),
                kernel_scorings_per_s=len(full) * B / (ms / 1e3))

    extra = {}
    if not linear:
        # K2 against itself at one row per block and K1 at K2's rows per
        # block: what the rows per block buy, and what renormalising at
        # every position costs
        G = launch_f["group"]
        extra["rows_vs_renorm"] = dict(
            group=G, k2_ms=ms,
            k2_one_row_ms=cuda_ms(lambda: kernel(*args_f, group=1, **kw), 2),
            k1_same_group_ms=cuda_ms(
                lambda: T.mapped_scores_log(*args_f, group=G, **kw), 2))
        # the rescue's launch: the batch K3 flags on the draft, all reads
        r_args, n_c, n_r = rescue_args
        extra["rescue_shape"] = dict(
            C=n_c, B=n_r, launch=plan(r_args),
            ms=cuda_ms(lambda: kernel(*r_args, **kw), 3))
    else:
        # the blocked candidate through score_candidates: K3 flags it, K2
        # rescores it, the draft's copy numbers stay with K3
        lin = TP.make_scorer(ctx["tpl"], ctx["pos"], ctx["codes"],
                             ctx["lens"], params, device, space="linear")
        batch = [full[0], full[i_blk]]
        reset_counters()
        times = TP.StageTimes(k=dbg.k)
        scores = TP.score_candidates(dbg, batch, genome_size, 100, lin, times)
        launches, twins = read_counters()
        flagged = int(np.isneginf(got[0]).any()) + 1  # the draft may be too
        assert times.n_rescued == flagged, (times.n_rescued, flagged)
        assert launches["K3"] > 0 and launches["K2"] > 0, launches
        assert not any(twins.values()), twins
        k2_sum = kernel_sum(T.mapped_scores_log_single, T.log_inv_total,
                            full[i_blk])
        assert np.isclose(scores[1].likelihood, k2_sum, rtol=1e-12, atol=0), \
            (scores[1].likelihood, k2_sum)
        extra["rescue"] = dict(rescued=times.n_rescued,
                               likelihood=scores[1].likelihood,
                               k2_launches=launches["K2"],
                               k3_launches=launches["K3"])

    emit(f"{kid.lower()}_parity", t0, ptxas=ptx, real=real_out,
         synthetic=synth, main_shape=main, **extra)
    ctx[f"{kid.lower()}_full"] = out_f  # for mesh_scorer
    return dict(max_abs_err=err_max, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])


def phase_refine(maps98, ref_proc, tmp):
    """The GPU's (float32) seeded + refined mappings of the first reads
    against the child's float64 CPU ones (``ref_refine``)."""
    t0 = time.perf_counter()
    ref = cpu_reference_of(ref_proc, tmp, "refine")
    R = len(ref["read_logps"])
    rel, agree = hold_to_reference(first_reads(maps98, R), ref, "refine")
    emit("refine", t0, reads=R, cpu_f64_s=float(ref["seconds"]),
         max_rel_logp_diff=rel, top1_agree=agree)


def hold_to_reference(maps, ref, what):
    """A GPU mapping of the reference's reads against its float64 CPU
    one: read log-likelihoods to 1e-4 relative and >= 99% of positions
    with the same top-1 node.  Returns (max relative diff, agreement)."""
    import numpy as np

    R = len(ref["read_logps"])
    got = maps.read_logps[:R]
    assert np.isfinite(got).all(), (what, got)
    rel = np.abs(got - ref["read_logps"]) / np.abs(ref["read_logps"])
    top1 = np.concatenate([a[:, 0] for a in maps.nodes[:R]])
    has = (top1 >= 0) | (ref["top1"] >= 0)
    agree = float((top1 == ref["top1"])[has].mean())
    assert rel.max() <= 1e-4, (what, rel)
    assert agree >= 0.99, (what, agree)
    return float(rel.max()), agree


def phase_scorer_spaces(device, params, ds, dbg, maps98):
    import numpy as np

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP

    t0 = time.perf_counter()
    reads = list(ds.reads)
    posts, out, kernel_of = {}, {}, {"packed": "K1", "log": "K2", "linear": "K3"}
    for space in ("packed", "log", "linear"):
        times = TP.StageTimes(k=dbg.k)
        reset_counters()
        t1 = time.perf_counter()
        posts[space] = TP.sample_posterior(
            dbg, params, reads, maps98, ds.genome_size(), 100, device,
            max_iter=1, times=times, scorer_space=space)
        launches, twins = read_counters()
        assert launches[kernel_of[space]] > 0, (space, launches)
        assert not any(twins.values()), (space, twins)
        out[space] = dict(wall_s=time.perf_counter() - t1,
                          score_s=times.score_s, n_scorings=times.n_scorings,
                          scorings_per_s=times.n_scorings / times.score_s,
                          setup_s=times.setup_s, n_rescued=times.n_rescued,
                          launches=launches, n_samples=len(posts[space].samples))
    ref = posts["packed"]
    n_reads = len(reads)
    for space in ("log", "linear"):
        p = posts[space]
        assert p.max_copy_nums() == ref.max_copy_nums(), space
        assert (p.max_sample().to_infos_string()
                == ref.max_sample().to_infos_string()), space
        assert [x.copy_nums for x in p.samples] == [
            x.copy_nums for x in ref.samples], space
        d = [0.0]
        for x in p.samples:
            got, r = x.score.likelihood, ref.find(x.copy_nums).score.likelihood
            if np.isneginf(r):  # a read no path explains: exact in log space
                assert np.isneginf(got), (space, got, r)
                continue
            tol = REL_TOL * abs(r) + ABS_TOL * n_reads
            assert abs(got - r) <= tol, (space, got, r)
            d.append(abs(got - r))
        out[space]["max_abs_diff_vs_packed"] = float(max(d))
        out[space]["n_samples_neginf"] = int(sum(
            np.isneginf(x.score.likelihood) for x in p.samples))
    moved = ref.max_copy_nums() != dbg.get_copy_nums()
    emit("scorer_spaces", t0, reads=n_reads, moved=moved,
         move=ref.max_sample().to_infos_string(), spaces=out)
    return out, ref


def phase_inspect(device, json_path, dbg_path):
    import numpy as np

    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as mdo
    from dbgphmm_tpu_torch.phmm.template import make_template
    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions

    t0 = time.perf_counter()
    ds = Dataset.from_json_file(json_path)
    dbg = mdo.from_dbg_file(dbg_path)
    # observe the mapping the CLI builds, to score its two candidates by K1
    seen = []
    real_generate = TP.generate_mappings

    def recording(*a, **kw):
        seen.append(real_generate(*a, **kw))
        return seen[-1]

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["inspect", "-d", str(dbg_path), str(json_path), "-o",
                os.path.join(tmp, "out")]
        buf = io.StringIO()
        TP.generate_mappings = recording
        reset_counters()
        try:
            with contextlib.redirect_stdout(buf):
                scores = cli.main(argv)
        except BaseException:
            sys.stderr.write("\n".join(buf.getvalue().splitlines()[-60:]) + "\n")
            raise
        finally:
            TP.generate_mappings = real_generate
        launches, twins = read_counters()
        assert launches["K2"] > 0, f"K2 never ran in inspect: {launches}"
        assert not any(twins.values()), twins
        assert os.path.exists(os.path.join(tmp, "out.true.map"))
    lines = [ln.split("\t")[:3] for ln in buf.getvalue().splitlines()
             if ln.startswith(("orig\t", "true\t"))]
    assert [ln[0] for ln in lines] == ["orig", "true"], lines

    # K1 on the CLI's mapping, the same two candidates
    maps = seen[-1]
    params = ds.params
    cn_orig = dbg.get_copy_nums()
    cn_true = cli._true_compact_copy_nums(dbg, dbg.paths_from_styled_seqs(ds.genome))
    codes, lens = pad_reads(list(ds.reads))
    tpl = make_template(dbg, params)
    pos = precompute_positions(
        pad_mappings(maps, codes.shape[1], max(a.shape[1] for a in maps.nodes)),
        tpl.parent_idx, parent_exists=tpl.parent_exists)
    per = T.MappedScorer(tpl, pos, codes, lens, tpl.params, device).per_read(
        [cn_orig, cn_true])
    out = {}
    for row, name, sc in zip(per, ("orig", "true"), scores):
        tol = float(np.sum(REL_TOL * np.abs(row[np.isfinite(row)]) + ABS_TOL))
        k1 = float(row.sum())
        assert abs(sc.likelihood - k1) <= tol, (name, sc.likelihood, k1, tol)
        out[name] = dict(k2=sc.likelihood, k1=k1, tol=tol, p=sc.p())
    emit("inspect", t0, argv=argv[:1], reads=len(ds.reads),
         full_edges=dbg.n_edges_full(), k2_launches=launches["K2"], **out)
    return launches["K2"]


def run_sim_infer(phase, json_path, dbg_path, k_max, ks, out_dir):
    """The port's CLI ``sim-infer <json> -d <dbg> -o <out_dir>/out -K k_max
    -I 1`` in this process: the K1 kernel ran, no twin did, no likelihood
    is NaN, the per-k files of ``ks`` exist; K1's launches in each stage;
    R2 launched for every stage's mapping and R1 for those refined from a
    hint, no plain version ran.  The files and the CLI's log (``out.log``)
    stay in ``out_dir`` for the tools phase.  Returns ({kernel id:
    launches}, the first stage's mapping of the draft: a dict of the
    Mappings, its params, the hint it was refined from, its R1 / R2
    launches, its seed and refine seconds)."""
    import numpy as np

    from dbgphmm_tpu_torch import cli

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    t0 = time.perf_counter()
    # K1 launches of each stage's climb: the counter read around each
    # sample_posterior call (one per k-stage and one for the final pass),
    # and R1 / R2 launches of each stage's mapping (read around the outer
    # generate_mappings call)
    per_stage = []
    real_sample = TP.sample_posterior

    def counting(dbg, *a, **kw):
        n0 = T.mapped_scores_log.launches
        post = real_sample(dbg, *a, **kw)
        per_stage.append(dict(k=dbg.k, k1_launches=T.mapped_scores_log.launches - n0,
                              samples=len(post.samples)))
        return post

    # the first stage's mapping of the draft and the hint it was refined
    # from, kept for the phases after (generate_mappings calls itself for
    # the seeded hint and per read chunk: the outer call and the first
    # call with a hint)
    real_generate = TP.generate_mappings
    first, depth, per_mapping = {}, [0], []

    def capturing(dbg, params, reads, device, **kw):
        if depth[0] == 0:
            n0 = read_counters()
        elif kw.get("hint") is not None and "hint" not in first:
            first["hint"] = kw["hint"]
        depth[0] += 1
        try:
            maps = real_generate(dbg, params, reads, device, **kw)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            n1 = read_counters()
            per_mapping.append(dict(
                k=dbg.k, reads=len(reads),
                **{f"{kid.lower()}_launches": n1[0][kid] - n0[0][kid]
                   for kid in ("R1", "R2", "A1", "A2")},
                twin_calls=sum(n1[1].values()) - sum(n0[1].values())))
            if "maps" not in first:
                times = kw.get("times")
                first.update(maps=maps, params=params, launches=per_mapping[0],
                             seed_s=times.seed_s if times else None,
                             refine_s=times.refine_s if times else None)
        return maps

    os.makedirs(out_dir)
    prefix = os.path.join(out_dir, "out")
    argv = ["sim-infer", str(json_path), "-d", str(dbg_path), "-o", prefix,
            "-K", str(k_max), "-I", "1"]
    TP.sample_posterior = counting
    TP.generate_mappings = capturing
    reset_counters()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            dbg, post, stages = cli.main(argv)
    except BaseException:
        # the CLI's own log, for the failure's context
        sys.stderr.write("\n".join(buf.getvalue().splitlines()[-60:]) + "\n")
        raise
    finally:
        TP.sample_posterior = real_sample
        TP.generate_mappings = real_generate
        Path(prefix + ".log").write_text(buf.getvalue())
    launches, twins = read_counters()
    assert launches["K1"] > 0, f"{phase}: the K1 kernel never ran"
    # every stage maps its reads through the refine (the seeded hint, or
    # the last stage's mapping) or, on a small graph's first stage, the
    # sparse-adaptive decode: R2 in each, R1 wherever there was a hint
    assert launches["R1"] > 0 and launches["R2"] >= launches["R1"], launches
    assert all(m["r2_launches"] > 0 for m in per_mapping), per_mapping
    # a mapping that is not refined from a hint decodes from scratch: the
    # sparse-adaptive forward's A1 (A2 only on the frontier)
    assert all(m["r1_launches"] > 0 or m["a1_launches"] > 0
               for m in per_mapping), per_mapping
    assert not any(twins.values()), f"{phase}: a twin ran on CUDA: {twins}"
    lls = np.asarray([s.score.likelihood for s in post.samples])
    assert not np.isnan(lls).any(), f"{phase}: NaN likelihood"
    files = sorted(os.listdir(out_dir))
    for k in ks:
        for ext in ("dbg", "map.mpz", "post", "gfa", "inspect"):
            assert f"out.k{k}.{ext}" in files, f"{phase}: missing out.k{k}.{ext}"
    assert "out.final.euler.fa" in files
    tail = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("# assembled=", "[mappings] dense"))]
    assert sum(st["k1_launches"] for st in per_stage) == launches["K1"]
    emit(phase, t0, argv=argv[:1] + argv[4:], launches=launches["K1"],
         k1_launches_per_stage=per_stage,
         r1_launches=launches["R1"], r2_launches=launches["R2"],
         a1_launches=launches["A1"], a2_launches=launches["A2"],
         refine_launches_per_mapping=per_mapping,
         twin_calls=twins["K1"], final_k=dbg.k, n_samples=len(lls),
         n_finite=int(np.isfinite(lls).sum()), log=tail,
         stages=[st.as_dict() for st in stages])
    return launches, first


# -- the from-scratch decodes --------------------------------------------------


def u500_argv(n_unit, prefix):
    """``sim-draft`` of a u500 dataset: a diploid tandem repeat of n_unit
    units of 500 bases between 300-base unique ends, 15x full-length reads
    at 0.1% error, and its k=40 draft."""
    return ["sim-draft", "-k", "40", "--unit-size", "500", "--n-unit",
            str(n_unit), "--unit-seed", "0", "--div-init", "0.02", "--div-seed",
            "1", "--end-length", "300", "-P", "2", "--div-hap", "0.02",
            "--hap-seed", "0", "-C", "15", "-L", "10000", "-p", "0.001", "-o",
            str(prefix)]


U500 = {"dense": 3, "adaptive": 8}  # phase: --n-unit
REF_READS = {"refine": 4, "dense": 4, "adaptive": 4, "frontier": 1}  # held to f64
FRONTIER_READS = 4
FRONTIER_LEN = 2500  # bases of each frontier read (a quarter of one)
SPEED_FB_L = 1000  # bases of each read of speed_test's fwd-bwd part
BATCH_READS = 4
MESH_DECODE_READS = 8  # mesh_path's sharded decode of u500(3)


def phase_datasets(tmp):
    """The two u500 datasets, by the port's sim-draft (in this process)."""
    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.multi_dbg import output as out

    t0 = time.perf_counter()
    info = {}
    for name, n_unit in U500.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ds = cli.main(u500_argv(n_unit, Path(tmp) / f"u{n_unit}"))
        dbg = out.from_dbg_file(Path(tmp) / f"u{n_unit}.dbg")
        info[name] = dict(n_unit=n_unit, reads=len(ds.reads),
                          max_read=max(len(r) for r in ds.reads),
                          full_edges=dbg.n_edges_full(),
                          compact_edges=dbg.n_edges_compact(),
                          genome_size=ds.genome_size())
    emit("datasets", t0, **info)
    return info


def save_reference(tmp, name, **arrays):
    """ref_<name>.npz in ``tmp``, written under another name and renamed,
    so that a reader never sees a half-written file."""
    import numpy as np

    part = Path(tmp) / f"ref_{name}.part.npz"
    np.savez(part, **arrays)
    os.replace(part, Path(tmp) / f"ref_{name}.npz")


def batch_candidates(dbg):
    """The batch phase's candidates: the draft's copy numbers and three
    neighbours that add one copy to compact edge 0, 1 or 2."""
    base = list(dbg.get_copy_nums())
    cands = [base]
    for e in range(3):
        cn = list(base)
        cn[e] += 1
        cands.append(cn)
    return cands


def cpu_reference(tmp):
    """The child process: the float64 CPU mappings of the first reads of
    the refine and decode phases, and the batch phase's float64 score, each
    saved as ref_<phase>.npz in ``tmp``."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg.posterior import generate_mappings
    from dbgphmm_tpu_torch.phmm.params import PHMMParams

    torch.set_num_threads(4)
    params = PHMMParams.uniform(0.001)
    bench = (ROOT / "data/bench/data.json", ROOT / "data/bench/data.dbg")
    cases = [("refine", *bench)]
    cases += [(name, Path(tmp) / f"u{n}.json", Path(tmp) / f"u{n}.dbg")
              for name, n in U500.items()]
    cases.append(("frontier", *bench))
    for name, js, dbg_path in cases:
        t0 = time.perf_counter()
        reads = list(Dataset.from_json_file(js).reads)[:REF_READS[name]]
        if name == "frontier":
            os.environ["DBGPHMM_SEED_MAPPING"] = "0"
            reads = [r[:FRONTIER_LEN] for r in reads]
        dbg = out.from_dbg_file(dbg_path)
        maps = generate_mappings(dbg, params, reads, "cpu")
        save_reference(tmp, name, read_logps=maps.read_logps,
                       top1=np.concatenate([a[:, 0] for a in maps.nodes]),
                       seconds=time.perf_counter() - t0)
        if name == "dense":
            batch_reference(tmp, dbg, params, reads)


def batch_reference(tmp, dbg, params, reads):
    """The batch phase's float64 CPU score: the ``table`` command's
    per-read forward of u500(3)'s first read."""
    import torch

    from dbgphmm_tpu_torch.ops.forward import forward_scores, pad_reads, to_device

    t0 = time.perf_counter()
    codes, lens = pad_reads(reads[:1])
    dm = to_device(dbg.to_phmm(params), "cpu", torch.float64)
    table = forward_scores(dm, torch.as_tensor(codes), torch.as_tensor(lens))
    save_reference(tmp, "batch", table=table.numpy(),
                   seconds=time.perf_counter() - t0)


def start_cpu_reference(tmp):
    log = open(Path(tmp) / "cpu_reference.log", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--cpu-reference", str(tmp)], cwd=ROOT,
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def cpu_reference_of(proc, tmp, name):
    """The child's float64 result of phase ``name`` (waiting for it)."""
    import numpy as np

    path = Path(tmp) / f"ref_{name}.npz"
    while not path.exists():
        if proc.poll() is not None:
            raise RuntimeError(
                "the CPU reference process failed:\n"
                + (Path(tmp) / "cpu_reference.log").read_text()[-3000:])
        time.sleep(2)
    return dict(np.load(path))


def phase_decode(name, device, params, json_path, dbg_path, ref_proc, tmp,
                 n_reads=None, read_len=None, env=None):
    """generate_mappings from scratch on the GPU (the first ``n_reads``
    reads, each cut to ``read_len`` bases if given); the decode branch it
    took; the first reads against the CPU's float64 decode."""
    import numpy as np

    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP

    t0 = time.perf_counter()
    ds = Dataset.from_json_file(json_path)
    dbg = out.from_dbg_file(dbg_path)
    reads = [r[:read_len] for r in list(ds.reads)[:n_reads]]
    calls = []

    def recording(fn):
        def wrapped(dm, codes, lens, **kw):
            calls.append(dict(fn=fn.__name__, B=int(codes.shape[0]),
                              L=int(codes.shape[1]), n=int(dm.emission.shape[0]),
                              **{k: v for k, v in kw.items()
                                 if k in ("n_top", "n_warmup", "stored_k",
                                          "store_bf16")}))
            return fn(dm, codes, lens, **kw)
        return wrapped

    real = {f: getattr(TP, f) for f in ("node_freqs_and_mappings",
                                        "mappings_sparse_adaptive")}
    old_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    times = TP.StageTimes(k=dbg.k)
    buf = io.StringIO()
    try:
        for f, fn in real.items():
            setattr(TP, f, recording(fn))
        reset_counters()
        with contextlib.redirect_stdout(buf):
            maps = TP.generate_mappings(dbg, params, reads, device, times=times)
        launches, twins = read_counters()
    finally:
        for f, fn in real.items():
            setattr(TP, f, fn)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    n = dbg.n_edges_full()
    want = {"dense": "node_freqs_and_mappings"}.get(name, "mappings_sparse_adaptive")
    assert calls and all(c["fn"] == want for c in calls), (name, calls)
    if name == "adaptive":
        assert all(c["n_warmup"] == c["L"] and c["stored_k"] is None
                   for c in calls), calls
    if name == "frontier":
        assert all(c["n_warmup"] == 16 and c["store_bf16"] for c in calls), calls
    # the sparse-adaptive decodes run A1 (the frontier also A2) and R2 once
    # per call, the dense one none of them; no plain version ran
    want_r2 = 0 if name == "dense" else len(calls)
    assert launches["R2"] == want_r2 and launches["R1"] == 0, (name, launches)
    assert launches["A1"] == want_r2, (name, launches)
    assert launches["A2"] == (want_r2 if name == "frontier" else 0), (name, launches)
    assert not any(twins.values()), (name, twins)
    assert np.isfinite(maps.read_logps).all(), maps.read_logps
    chunk = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[mappings] dense decode")]
    bases = sum(len(r) for r in reads)

    ref = cpu_reference_of(ref_proc, tmp, name)
    rel, agree = hold_to_reference(maps, ref, name)
    emit(f"{name}_decode", t0, reads=len(reads), bases=bases, full_edges=n,
         calls=calls, r2_launches=launches["R2"], a1_launches=launches["A1"],
         a2_launches=launches["A2"], decode_s=times.decode_s,
         decode_s_per_read_base=times.decode_s / bases,
         width=max(a.shape[1] for a in maps.nodes), dense_chunk=chunk,
         ref_reads=len(ref["read_logps"]), max_rel_logp_diff=rel,
         top1_agree=agree, cpu_f64_s=float(ref["seconds"]))
    return maps


def phase_batch(device, params, json_path, dbg_path, reads_fa, dense_maps,
                ref_proc, tmp):
    """Batch scoring and the ``table`` command on u500(3), the paths of
    sample_posterior without mappings: candidate_log_likelihoods of
    batch_candidates() on the first reads, dense and over the GPU's dense
    decode of them, in float32 against float64 on the card (1e-4
    relative, the decode gates); sample_posterior(mappings=None,
    max_iter=1) on the same reads through BatchScorer, launching no scorer
    kernel and no twin, its draft sample against the float64 score; the
    port's CLI ``table`` on all reads (float64 on the card) against the
    child's float64 CPU forward of the first read and against the float64
    dense score of the draft, to 1e-9 relative."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops.batch import candidate_log_likelihoods
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings
    from dbgphmm_tpu_torch.phmm.template import make_template

    t0 = time.perf_counter()
    ds = Dataset.from_json_file(json_path)
    dbg = out.from_dbg_file(dbg_path)
    reads = list(ds.reads)[:BATCH_READS]
    codes, lens = pad_reads(reads)
    maps = first_reads(dense_maps, len(reads))
    map_nodes = pad_mappings(maps, codes.shape[1],
                             max(a.shape[1] for a in maps.nodes))
    tpl = make_template(dbg, params)
    cands = batch_candidates(dbg)
    models = [tpl.model_for(cn) for cn in cands]

    def rel(got, want):
        return float(np.max(np.abs(got - want) / np.abs(want)))

    secs, errs, f64 = {}, {}, {}
    for branch, kw in (("dense", {}), ("mapped", {"map_nodes": map_nodes})):
        t1 = time.perf_counter()
        got = candidate_log_likelihoods(models, codes, lens, device, **kw)
        secs[branch] = time.perf_counter() - t1
        f64[branch] = candidate_log_likelihoods(models, codes, lens, device,
                                                dtype=torch.float64, **kw)
        assert np.isfinite(got).all(), (branch, got)
        errs[branch] = rel(got, f64[branch])
        assert errs[branch] <= 1e-4, (branch, got, f64[branch])

    # the entry point: sample_posterior without mappings scores through
    # BatchScorer; count its calls and hold it to no kernel and no twin
    batch_calls = []
    real = TP.candidate_log_likelihoods

    def counting(models, *a, **kw):
        batch_calls.append(len(models))
        return real(models, *a, **kw)

    reset_counters()
    t1 = time.perf_counter()
    TP.candidate_log_likelihoods = counting
    try:
        post = TP.sample_posterior(dbg.copy(), params, reads, None,
                                   ds.genome_size(), 100, device, max_iter=1)
    finally:
        TP.candidate_log_likelihoods = real
    secs["sample_posterior"] = time.perf_counter() - t1
    launches, twins = read_counters()
    assert not any(launches.values()) and not any(twins.values()), (launches, twins)
    assert batch_calls and max(batch_calls) <= TP.BatchScorer.SUB, batch_calls
    lls = np.asarray([smp.score.likelihood for smp in post.samples])
    assert np.isfinite(lls).all(), lls
    draft = post.find(cands[0])
    assert draft is not None
    errs["sample_posterior_draft"] = rel(np.asarray([draft.score.likelihood]),
                                         f64["dense"][:1])
    assert errs["sample_posterior_draft"] <= 1e-4, errs

    ref = cpu_reference_of(ref_proc, tmp, "batch")
    t1 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        table = cli.main(["table", "-d", str(dbg_path), str(reads_fa),
                          "--device", device.type])
    secs["table"] = time.perf_counter() - t1
    assert table.dtype == torch.float64 and table.device.type == device.type
    table = table.cpu().numpy()
    assert table.shape == (len(ds.reads),) and np.isfinite(table).all()
    errs["table_vs_cpu"] = rel(table[:1], ref["table"])
    errs["table_vs_batch"] = rel(table[:len(reads)].sum(), f64["dense"][0])
    assert max(errs["table_vs_cpu"], errs["table_vs_batch"]) <= 1e-9, (
        table[:len(reads)], ref["table"], f64["dense"][0])
    emit("batch", t0, reads=len(reads), table_reads=len(table),
         candidates=len(cands), map_width=int(map_nodes.shape[2]),
         posterior_candidates=len(post.samples), batch_calls=batch_calls,
         seconds=secs, max_rel_diff=errs, cpu_f64_s=float(ref["seconds"]))


def phase_speed_test(device):
    """``bench.main`` in this process: the two K1 parts at the benchmark's
    full shapes, the fwd-bwd part at B = 384 reads of SPEED_FB_L bases.
    Each part's launch counters are set to 0 just before it and read just
    after: K1 launched in both scorer parts, A1, A2 and R2 in the fwd-bwd
    decode, no twin ran anywhere.  Returns the fwd-bwd part's A2
    launches."""
    import numpy as np

    from dbgphmm_tpu_torch import bench

    t0 = time.perf_counter()
    parts = ("run_synthetic", "run_fwd_bwd", "run_real_graph")
    real = {name: getattr(bench, name) for name in parts}
    counts, secs = {}, {}

    def counting(name):
        def wrapped(*a, **kw):
            reset_counters()
            t1 = time.perf_counter()
            out = real[name](*a, **kw)
            secs[name] = time.perf_counter() - t1
            counts[name] = read_counters()
            return out
        return wrapped

    try:
        for name in parts:
            setattr(bench, name, counting(name))
        lines = bench.main(device=device, fb_L=SPEED_FB_L)
    finally:
        for name, fn in real.items():
            setattr(bench, name, fn)
    for name in ("run_synthetic", "run_real_graph"):
        assert counts[name][0]["K1"] > 0, (name, counts[name])
    fb = counts["run_fwd_bwd"][0]
    assert fb["R2"] > 0 and fb["A1"] > 0 and fb["A2"] > 0, fb
    assert not any(v for _l, twins in counts.values() for v in twins.values()), counts
    assert [ln["metric"] for ln in lines][-1] == \
        "torch_real_graph_k1_scorings_per_sec_k40", lines
    assert all(np.isfinite(ln["value"]) and ln["value"] > 0 for ln in lines), lines
    emit("speed_test", t0, part_s=secs,
         k1_launches={n: c[0]["K1"] for n, c in counts.items()},
         r2_launches=fb["R2"], a1_launches=fb["A1"], a2_launches=fb["A2"],
         values={ln["metric"]: ln["value"] for ln in lines})
    return fb["A2"]


TOOLS_VALIDATE = dict(reads=dict(length=600, min_length=300))  # cut from
# 4,400 bases: its full run is dbgphmm_tpu_torch/scripts/scale_runs.sh r3
TOOLS_TWIN_L = 2000  # read positions of the twin check (its time is per
# position, not per read)


def phase_tools(device, infer_json, tmp, ks=(40, 41)):
    """Each of the port's tools (dbgphmm_tpu_torch/scripts/, the JAX repo's
    scripts/) once, in this process, on files the earlier phases wrote:
    ``perk_budget`` on infer's log; ``bench_real_graph`` on infer's k=40
    (``ks[0]``) checkpoint of data/bench (the counters set to 0 just before
    it and read just after: K1 launched, no twin; then K1 on the first 8 of
    its candidates and the read block's streams, cut to their first
    TOOLS_TWIN_L positions, held to the float64 twin on the card, per
    read 1e-5 |ref| + 0.05 nats, the same best candidate);
    ``diag_mapping_quality``, ``audit_hint_upconversion``,
    ``diag_hint_relation`` and ``diag_hint_relation2`` on small_infer's
    k=40 -> 41 checkpoints (u500(8); ``ks``); ``dbgviz`` on its final graph;
    ``visualize_inspect`` on its two .inspect files (fails on the import
    where matplotlib is not installed, which is recorded); and
    ``validate_large_n_mapping`` at 74,083 full edges on reads cut to
    TOOLS_VALIDATE (VERDICT: OK).  Seconds of each tool."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.phmm.params import PHMMParams
    from dbgphmm_tpu_torch.scripts import (
        audit_hint_upconversion, bench_real_graph, dbgviz,
        diag_hint_relation, diag_hint_relation2, diag_mapping_quality,
        perk_budget, validate_large_n_mapping, visualize_inspect)

    t0 = time.perf_counter()
    secs, lines = {}, {}

    def run(name, fn, *args, **kw):
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(*args, **kw)
        secs[name] = time.perf_counter() - t1
        lines[name] = buf.getvalue().splitlines()
        return res

    inf, small = tmp / "infer" / "out", tmp / "small_infer" / "out"
    k0, k1 = ks
    run("perk_budget", perk_budget.main, [f"{inf}.log"])
    assert lines["perk_budget"][0].startswith(f"k={k0} sampling_s="), \
        lines["perk_budget"]

    captured = []
    real_setup = bench_real_graph.setup
    bench_real_graph.setup = lambda *a, **kw: captured.append(
        real_setup(*a, **kw)) or captured[-1]
    reset_counters()
    try:
        rec = run("bench_real_graph", bench_real_graph.main,
                  [f"{inf}.k{k0}.dbg", str(infer_json), f"{inf}.k{k0}.map.mpz",
                   "--device", str(device)])
    finally:
        bench_real_graph.setup = real_setup
    launches, twins = read_counters()
    assert launches["K1"] > 0 and not any(twins.values()), (launches, twins)
    assert np.isfinite(rec["value"]) and rec["value"] > 0, rec
    _dbg, _reads, _w, scorer, cands = captured[0]
    s, (lens, *streams) = scorer.chunks[0], scorer.block_streams(0)
    # each read's first TOOLS_TWIN_L bases: the streams are position-major
    dev_s = (lens.clamp(max=TOOLS_TWIN_L), *(t[:TOOLS_TWIN_L] for t in streams))
    nb = scorer.blocks[scorer.local_blocks[0]][3]
    eff, total = T._eff_matrix(s, np.asarray(cands[:8], dtype=np.float32))
    lt = T.lin_params(PHMMParams.uniform(0.0003), np.float64)
    args = lambda dt: (torch.as_tensor(eff, dtype=dt, device=device),
                       torch.as_tensor(T.log_inv_total(total), dtype=dt,
                                       device=device),
                       *dev_s, torch.as_tensor(lt, dtype=dt, device=device))
    kw = dict(n_max_gaps=scorer.n_max_gaps)
    got = T.mapped_scores_log(*args(torch.float32), **kw)[:, :nb]
    ref = T.mapped_scores_log_reference(*args(torch.float64), **kw)[:, :nb]
    got, ref = got.double().cpu().numpy(), ref.cpu().numpy()
    err = check_close(got, ref, "tools: bench_real_graph's K1")
    same_best(got, ref, "tools: bench_real_graph's K1")
    del captured, scorer, dev_s, streams

    run("diag_mapping_quality", diag_mapping_quality.main,
        [f"{small}.k{k0}.dbg", f"{small}.k{k0}.map.mpz"])
    for name, mod in (("audit_hint_upconversion", audit_hint_upconversion),
                      ("diag_hint_relation", diag_hint_relation),
                      ("diag_hint_relation2", diag_hint_relation2)):
        run(name, mod.main, [str(small), str(k0), str(k1)])
    run("dbgviz", dbgviz.main, [f"{small}.final.dbg", "--inspect",
                                f"{small}.final.inspect", "-o",
                                str(tmp / "graph.html")])
    assert "cytoscape" in (tmp / "graph.html").read_text()
    try:
        run("visualize_inspect", visualize_inspect.main,
            [f"{small}.k{k0}.inspect", f"{small}.k{k1}.inspect", "-o",
             str(tmp / "inspect.png")])
        plot = "written"
        assert (tmp / "inspect.png").stat().st_size > 0
    except ModuleNotFoundError as e:
        assert e.name == "matplotlib", e
        plot = "matplotlib not installed"
    val = run("validate_large_n_mapping", validate_large_n_mapping.main,
              ["--device", str(device)], **TOOLS_VALIDATE)
    assert val["ok"] and lines["validate_large_n_mapping"][-1] == "# VERDICT: OK"
    emit("tools", t0, tool_s=secs, bench_real_graph=rec,
         k1_launches=launches["K1"], k1_twin_max_abs_err=err,
         k1_twin_shape=[int(eff.shape[0]), int(nb)],
         perk_budget=lines["perk_budget"],
         diag_mapping_quality=lines["diag_mapping_quality"][1:3],
         audit_hint_upconversion=lines["audit_hint_upconversion"][-4:-1],
         visualize_inspect=plot,
         validate=dict(lines=lines["validate_large_n_mapping"][1:],
                       dense_s=val["dense_s"], frontier_s=val["frontier_s"]))


# -- the scale-out -------------------------------------------------------------


def one_card_mesh(device, n, cand_axis):
    """A ("cand", "reads") mesh of ``n`` shards that all name ``device``."""
    from dbgphmm_tpu_torch.parallel import make_mesh

    return make_mesh(n, cand_axis=cand_axis, devices=[device] * n)


def phase_mesh_scorer(device, params, ctx):
    """K1, K2 and K3 through MappedScorer(mesh=) on a 2x2 mesh of the one
    card, at the parity phases' main shape (the draft's ~2,980 candidates
    x 16 reads), against the unsharded launches those phases made: per
    read the same scores (0 difference expected; the kernel gate is the
    most allowed), the same -inf pattern and best candidate; launches =
    shards x read chunks, no twin; ms of the sharded and the unsharded
    (no mesh given: the 1x1 mesh) scorer's per_read (host work, launches
    and copies)."""
    import numpy as np

    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    t0 = time.perf_counter()
    mesh = one_card_mesh(device, 4, 2)
    full, B, order = ctx["full"], ctx["B"], ctx["scorer"].order
    out = {}
    for kid, space in (("K1", "packed"), ("K2", "log"), ("K3", "linear")):
        mk = lambda m: T.MappedScorer(ctx["tpl"], ctx["pos"], ctx["codes"],
                                      ctx["lens"], params, device,
                                      space=space, mesh=m)
        sharded = mk(mesh)
        reset_counters()
        got = sharded.per_read(full)
        launches, twins = read_counters()
        n_chunks = len({b[0] for b in sharded.blocks})
        assert launches[kid] == mesh.size * n_chunks, (kid, launches)
        assert sum(launches.values()) == launches[kid], launches
        assert not any(twins.values()), twins
        ref = np.empty_like(got)
        ref[:, order] = ctx[f"{kid.lower()}_full"][:, :B].double().cpu().numpy()
        err = check_close(got, ref, f"{kid} on the 2x2 mesh")
        same_best(got, ref, f"{kid} on the 2x2 mesh")
        unsharded = mk(None)
        out[kid] = dict(
            launches=launches[kid], read_chunks=n_chunks,
            blocks=[list(b) for b in sharded.blocks], max_abs_diff=err,
            bit_equal=bool(np.array_equal(got, ref)),
            sharded_ms=cuda_ms(lambda: sharded.per_read(full), 1),
            unsharded_ms=cuda_ms(lambda: unsharded.per_read(full), 1))
    emit("mesh_scorer", t0, mesh=mesh.shape, C=len(full), B=B, kernels=out)


def phase_mesh_path(device, params, ds, dbg, maps98, post_packed, json_path,
                    dbg_path, dense_maps):
    """The sharded paths of the decodes and the climb on the one card:
    generate_mappings(mesh=1x2) on u500(3)'s first MESH_DECODE_READS reads
    against the same reads of dense_decode's unsharded decode (<= 1e-6
    relative, >= 99.9% equal top-1 nodes; bit equality expected); the
    seeded refine (R1, R2) with mesh=1x2 on data/bench's first
    MESH_DECODE_READS reads against the infer phase's unsharded mapping of
    them (the same gates; R1 and R2 launched shards x read chunks times);
    sample_posterior(mesh=2x2, max_iter=1) on data/bench with the shared
    mapping against scorer_spaces' packed posterior (the same inputs): the
    same samples and max_copy_nums, likelihoods within 1e-5 relative, K1
    launched and no twin; dryrun_multichip(4) on four copies of the card."""
    import numpy as np

    from dbgphmm_tpu_torch import dryrun
    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as mdo
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP

    t0 = time.perf_counter()
    out = {}
    ds3, dbg3 = Dataset.from_json_file(json_path), mdo.from_dbg_file(dbg_path)
    reads = list(ds3.reads)[:MESH_DECODE_READS]
    mesh = one_card_mesh(device, 2, 1)
    times = TP.StageTimes(k=dbg3.k)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        maps = TP.generate_mappings(dbg3, params, reads, device, times=times,
                                    mesh=mesh)
    ref = first_reads(dense_maps, len(reads))
    rel = np.abs(maps.read_logps - ref.read_logps) / np.abs(ref.read_logps)
    top1 = np.concatenate([a[:, 0] for a in maps.nodes])
    top1_ref = np.concatenate([a[:, 0] for a in ref.nodes])
    agree = float((top1 == top1_ref).mean())
    assert np.isfinite(maps.read_logps).all(), maps.read_logps
    assert rel.max() <= 1e-6 and agree >= 0.999, (rel.max(), agree)
    same_nodes = all(
        np.array_equal(a[:, :w], b[:, :w]) and (a[:, w:] < 0).all()
        and (b[:, w:] < 0).all()
        for a, b in zip(maps.nodes, ref.nodes)
        for w in [min(a.shape[1], b.shape[1])])
    out["decode"] = dict(
        mesh=mesh.shape, reads=len(reads), decode_s=times.decode_s,
        max_rel_logp_diff=float(rel.max()), top1_agree=agree,
        bit_equal=bool(np.array_equal(maps.read_logps, ref.read_logps)
                       and same_nodes),
        log=[ln for ln in buf.getvalue().splitlines() if "[mappings]" in ln])

    # the seeded refine on data/bench's first reads over a 1x2 mesh: R1 and
    # R2 once per shard block and read chunk, against the same reads of
    # the infer phase's unsharded mapping (the decode's gates)
    reads = list(ds.reads)[:MESH_DECODE_READS]
    mesh = one_card_mesh(device, 2, 1)
    times = TP.StageTimes(k=dbg.k)
    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        maps = TP.generate_mappings(dbg, params, reads, device, times=times,
                                    mesh=mesh)
    launches, twins = read_counters()
    n_chunks = -(-len(reads) // TP.MAPPING_READ_CHUNK)
    assert launches["R1"] == launches["R2"] == mesh.size * n_chunks, launches
    assert not any(twins.values()), twins
    ref = first_reads(maps98, len(reads))
    rel = np.abs(maps.read_logps - ref.read_logps) / np.abs(ref.read_logps)
    top1 = np.concatenate([a[:, 0] for a in maps.nodes])
    top1_ref = np.concatenate([a[:, 0] for a in ref.nodes])
    agree = float((top1 == top1_ref).mean())
    assert np.isfinite(maps.read_logps).all(), maps.read_logps
    assert rel.max() <= 1e-6 and agree >= 0.999, (rel.max(), agree)
    out["refine"] = dict(mesh=mesh.shape, reads=len(reads),
                         r1_launches=launches["R1"], r2_launches=launches["R2"],
                         seed_s=times.seed_s, refine_s=times.refine_s,
                         max_rel_logp_diff=float(rel.max()), top1_agree=agree)

    mesh = one_card_mesh(device, 4, 2)
    times = TP.StageTimes(k=dbg.k)
    reset_counters()
    t1 = time.perf_counter()
    post = TP.sample_posterior(dbg, params, list(ds.reads), maps98,
                               ds.genome_size(), 100, device, max_iter=1,
                               times=times, mesh=mesh)
    wall = time.perf_counter() - t1
    launches, twins = read_counters()
    assert launches["K1"] > 0 and not any(twins.values()), (launches, twins)
    assert post.max_copy_nums() == post_packed.max_copy_nums()
    got = {tuple(x.copy_nums): x.score.likelihood for x in post.samples}
    want = {tuple(x.copy_nums): x.score.likelihood for x in post_packed.samples}
    assert set(got) == set(want), (len(got), len(want))
    rels = [abs(got[k] - v) / abs(v) for k, v in want.items() if np.isfinite(v)]
    assert all(np.isneginf(got[k]) for k, v in want.items() if np.isneginf(v))
    assert max(rels) <= 1e-5, max(rels)
    out["sample_posterior"] = dict(
        mesh=mesh.shape, reads=len(ds.reads), samples=len(post.samples),
        k1_launches=launches["K1"], wall_s=wall, score_s=times.score_s,
        setup_s=times.setup_s, max_rel_likelihood_diff=float(max(rels)),
        equal=all(got[k] == v for k, v in want.items()))

    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        post = dryrun.dryrun_multichip(4, devices=[device] * 4)
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("dryrun_multichip OK")]
    assert line and post.max_copy_nums() == [2, 1, 1, 2], buf.getvalue()[-2000:]
    out["dryrun"] = dict(s=time.perf_counter() - t1, line=line[0])
    emit("mesh_path", t0, **out)


DIST_RANK = """
import json, sys
from dbgphmm_tpu_torch import cli
from dbgphmm_tpu_torch.ops import mapped_scorer as T
cli.main(sys.argv[1:])
print("# launches " + json.dumps({n: getattr(T, n).launches for n in (
    "mapped_scores_log", "mapped_scores_log_single", "mapped_scores_linear")})
      + " twins " + json.dumps({n: getattr(T, n).calls for n in (
    "mapped_scores_log_reference", "mapped_scores_log_single_reference",
    "mapped_scores_linear_reference")}))
"""


def phase_dist(device, tmp):
    """The CLI's ``sample`` on tests/test_multihost.py's toy (started one
    +-1 cycle off the truth; 12 reads, so that each rank's half of the
    "reads" axis holds reads: 8 and 4) in two ranks on the one card
    (``--dist localhost:P,2,i --mesh 1x2``, gloo), each a child process
    that prints its scorer launches, and once alone in this process: both
    ranks exit 0, each launched K1 and no twin, and each rank's .post file
    equals the single run's (times stripped)."""
    import re
    import socket

    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.multi_dbg import MultiDbg
    from dbgphmm_tpu_torch.multi_dbg import output as mdo
    from dbgphmm_tpu_torch.seq.collection import StyledSequence

    t0 = time.perf_counter()
    d = Path(tmp) / "dist"
    d.mkdir()
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGTAGGATCC"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGTAGGATCC"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    dbg.set_copy_nums([2, 2, 0, 2])
    mdo.to_dbg_file(dbg, d / "toy.dbg")
    with open(d / "reads.fa", "w") as f:
        for i, r in enumerate([h1[2:30], h2[3:33], h1[:28], h2[4:], h1[5:34],
                               h2[:30], h1[1:31], h2[6:], h1[:33], h2[2:29],
                               h1[4:], h2[1:35]]):
            f.write(f">r{i}\n{r.decode()}\n")
    common = ["sample", "-d", str(d / "toy.dbg"), "-G", str(len(h1)), "-I",
              "5", str(d / "reads.fa"), "--device", device.type]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    # a rank whose peer failed stops well inside the 300 s wait below
    env = {**os.environ, "PYTHONPATH": str(ROOT), "DBGPHMM_DIST_TIMEOUT_S": "120"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_RANK, f"--dist=localhost:{port},2,{i}",
         "--mesh", "1x2", *common, "-o", str(d / f"rank{i}")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} exited {p.returncode}:\n{o[-3000:]}"
        m = re.search(r"# launches (\{.*\}) twins (\{.*\})", o)
        assert m, o[-3000:]
        launches, twins = json.loads(m.group(1)), json.loads(m.group(2))
        assert not any(twins.values()), (i, twins)
        assert launches["mapped_scores_log"] > 0, (i, launches)
        ranks.append(launches)

    reset_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main([*common, "-o", str(d / "single")])
    launches, twins = read_counters()
    assert launches["K1"] > 0 and not any(twins.values()), (launches, twins)
    strip = lambda t: re.sub(r'"time_[a-z]+":[0-9.e-]+', '"t":0', t)
    single = strip((d / "single.post").read_text())
    for i in range(2):
        assert strip((d / f"rank{i}.post").read_text()) == single, i
    emit("dist", t0, ranks=2, mesh="1x2", backend="gloo",
         rank_launches=ranks,
         single_k1_launches=launches["K1"],
         samples=single.count("\nC\t"), post_equal=True)


def main():
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "dbgphmm_tpu_torch").is_dir():
        print(f"chip_smoke: run from a checkout: no dbgphmm_tpu_torch/ in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = nvidia_smi_line()
    emit("device", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from dbgphmm_tpu_torch.e2e import Dataset
    from dbgphmm_tpu_torch.multi_dbg import output as out
    from dbgphmm_tpu_torch.phmm.params import PHMMParams
    from dbgphmm_tpu_torch.ops import _build

    t1 = time.perf_counter()
    # build from the sources, not from an earlier run's libraries: the
    # build's time and ptxas report belong to this run
    for so in _build.BUILD_DIR.glob("lib*.so"):
        so.unlink()
    _build.build_all()
    log = _build.BUILD_LOG
    ptxas = {stem: ptxas_of(log[stem]["output"])
             for stem in ("libmapped_scorer", "libmapped_scorer_linear",
                          "librefine", "libadaptive")}
    # R1: float32, float64; R2: (float32, float64) x (own type, bfloat16)
    # x one or two cells per thread; A1, A2: (float32, float64) x (own
    # type, bfloat16)
    assert len(ptxas["librefine"]) == 10, ptxas["librefine"]
    assert len(ptxas["libadaptive"]) == 8, ptxas["libadaptive"]
    for stem in ("librefine", "libadaptive"):
        assert all(e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                   for e in ptxas[stem]), ptxas[stem]
    emit("build", t1, k1_k2_nvcc_s=log["libmapped_scorer"]["seconds"],
         k3_nvcc_s=log["libmapped_scorer_linear"]["seconds"],
         r1_r2_nvcc_s=log["librefine"]["seconds"],
         a1_a2_nvcc_s=log["libadaptive"]["seconds"],
         host_gxx_s={n: log[f"lib{n}"]["seconds"] for n in _build.HOST_LIBS},
         ptxas=ptxas)

    device = torch.device("cuda")
    params = PHMMParams.uniform(0.001)  # the CLI's default --p-error
    bench_json, bench_dbg = ROOT / "data/bench/data.json", ROOT / "data/bench/data.dbg"
    ds = Dataset.from_json_file(bench_json)
    dbg = out.from_dbg_file(bench_dbg)
    with tempfile.TemporaryDirectory() as tmp:
        phase_datasets(tmp)
        ref_proc = start_cpu_reference(tmp)
        try:
            u = {name: (Path(tmp) / f"u{n}.json", Path(tmp) / f"u{n}.dbg")
                 for name, n in U500.items()}
            infer_launches, first = run_sim_infer(
                "infer", bench_json, bench_dbg, 40, (40,), Path(tmp) / "infer")
            maps98 = phase_mapping(params, ds, first)
            res = phase_refine_parity(device, params, ds, dbg, first)
            del first
            res.update(phase_adaptive_parity(device, params, *u["adaptive"]))
            launches = {kid: infer_launches[kid] for kid in ("R1", "R2")}
            res["K1"], ctx = phase_k1_parity(device, params, ds, dbg, maps98)
            ctx["blocked"] = blocked_candidate(device, ctx)
            res["K2"] = phase_parity("K2", device, params, dbg, ctx,
                                     ds.genome_size(),
                                     rescue_shape(device, params, ds, dbg, maps98))
            res["K3"] = phase_parity("K3", device, params, dbg, ctx,
                                     ds.genome_size())
            phase_mesh_scorer(device, params, ctx)
            del ctx
            phase_refine(maps98, ref_proc, tmp)
            spaces, post_packed = phase_scorer_spaces(device, params, ds, dbg,
                                                      maps98)
            launches.update(K2=phase_inspect(device, *u["dense"]),
                            K3=spaces["linear"]["launches"]["K3"])
            dense_maps = phase_decode("dense", device, params, *u["dense"],
                                      ref_proc, tmp)
            phase_batch(device, params, *u["dense"],
                        Path(tmp) / f"u{U500['dense']}.reads.fa", dense_maps,
                        ref_proc, tmp)
            phase_mesh_path(device, params, ds, dbg, maps98, post_packed,
                            *u["dense"], dense_maps)
            del dense_maps, maps98, post_packed
            phase_dist(device, tmp)
            phase_decode("adaptive", device, params, *u["adaptive"], ref_proc, tmp)
            phase_decode("frontier", device, params, bench_json, bench_dbg,
                         ref_proc, tmp, n_reads=FRONTIER_READS,
                         read_len=FRONTIER_LEN,
                         env={"DBGPHMM_SEED_MAPPING": "0"})
            small_launches, _ = run_sim_infer("small_infer", *u["adaptive"], 41,
                                              (40, 41), Path(tmp) / "small_infer")
            launches["K1"] = small_launches["K1"]
            launches["A1"] = small_launches["A1"]
            phase_tools(device, bench_json, Path(tmp))
            launches["A2"] = phase_speed_test(device)
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
            ref_proc.wait()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dbgphmm_tpu"))
    assert not foreign, f"the port imported {foreign[:5]}"

    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[kid], "max_abs_err": res[kid]["max_abs_err"],
        "ms": res[kid]["ms"], "plain_ms": res[kid]["plain_ms"],
        "bound_ms": res[kid]["bound_ms"], "bound_by": res[kid]["bound_by"],
        # no single PyTorch call computes a profile-HMM forward or backward
        "library_ms": None,
    } for kid, (_mod, name, src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.path.insert(0, str(ROOT))
        cpu_reference(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
