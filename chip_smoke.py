#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dbgphmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA GPU

Phases, each printing one JSON line with its wall time; any failure raises
and the script exits non-zero:

1. device     -- a CUDA GPU is present; its name and power limit (nvidia-smi).
2. build      -- builds the three scorer kernels (csrc/mapped_scorer.cu: K1
                 and K2; csrc/mapped_scorer_linear.cu: K3; nvcc, sm_90a) and
                 the four host libraries (csrc/host/*.cpp, g++) from the
                 checkout's sources, one compiler process each, all at once,
                 after deleting any library an earlier run left; prints each
                 kernel instance's ptxas registers and spills.
3. mapping    -- seeded + refined mappings of all 98 reads of the committed
                 k=40 draft on the GPU (params of the CLI's default
                 --p-error), computed once and shared by the phases below.
4. k1_parity  -- K1 against its plain PyTorch twin run on the card in
                 float64: a real case (16 reads of the draft at full length,
                 the draft's copy numbers + 15 rescue candidates, NC trimmed
                 as in production; one candidate per block), the main path's
                 launch shape (the draft's whole neighbourhood, ~2,980
                 candidates, on the same reads: several candidates per block
                 and a partial last group), and synthetic cases at A = 16, 64, 128
                 (D = 3, several 128-wide eff chunks, 21 candidates at 1 and 8
                 per block).  Per read |kernel - twin| <= 1e-5 |twin| + 0.05
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
                 candidate), and on the synthetic cases, against their
                 float64 twins with K1's tolerance and the same best
                 candidate.  K2: -inf exactly where the twin has it.  K3:
                 every read that is -inf in float64 is -inf in the kernel,
                 not the converse (float32 underflows ~11 bases into a
                 copy-0 stretch, float64 only after ~90).  At the main path's
                 shape the float64 twin is not run again: K2, and K3 where
                 finite, are held against the K1 output k1_parity checked;
                 one float32-twin call there gives plain_ms, and its real-case
                 rows the float32 -inf pattern and max difference.  K3's
                 blocked candidate goes through score_candidates with a
                 linear scorer, which must rescue it through K2.
6. refine     -- the first 4 reads' mappings refined on the CPU (float64)
                 against the GPU's (float32) from phase 3: read
                 log-likelihoods to 1e-4 relative, >= 99% of positions with
                 the same top-1 node.
7. scorer_spaces -- sample_posterior(max_iter=1) on all 98 reads with the
                 shared mapping, once per scorer space ("packed" K1, "log"
                 K2, "linear" K3 with the rescue): the same accepted move and
                 max_copy_nums, per-sample likelihoods within the summed
                 per-read tolerance; each space launches its kernel and no
                 twin; score seconds, scorings/s and candidates rescued.
8. inspect    -- the port's CLI, ``inspect -d data/bench/data.dbg
                 data/bench/data.json``, in this process: K2 ran, no twin
                 did, and the orig and true likelihoods agree with a K1
                 scoring of the same two candidates on the CLI's mapping.
9. infer      -- the port's CLI, ``sim-infer data/bench/data.json -d
                 data/bench/data.dbg -K 41 -I 1`` on all 98 reads (two
                 k-stages, purge + extension, the final full-neighbourhood
                 pass), in this process so that the launch counters can be
                 read: the K1 kernel ran, no twin did, no likelihood is NaN,
                 the per-k files exist; K1's launches in each stage.

Each path's launch counters are set to 0 just before it runs and read just
after.  Then, on lines of their own: the card's name and power limit as
nvidia-smi prints them, the kernel table ({"kernels": [...]}), and last
{"ok": true, "device": {...}}.
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
KERNELS = {  # id: (wrapper, source, the Pallas body it replaces)
    "K1": ("mapped_scores_log", "dbgphmm_tpu_torch/csrc/mapped_scorer.cu",
           f"{PALLAS}:718"),  # _make_kernel_log_packed
    "K2": ("mapped_scores_log_single", "dbgphmm_tpu_torch/csrc/mapped_scorer.cu",
           f"{PALLAS}:488"),  # _make_kernel_log
    "K3": ("mapped_scores_linear",
           "dbgphmm_tpu_torch/csrc/mapped_scorer_linear.cu",
           f"{PALLAS}:298"),  # _make_kernel
}
TWINS = {"K1": "mapped_scores_log_reference",
         "K2": "mapped_scores_log_single_reference",
         "K3": "mapped_scores_linear_reference"}
REL_TOL, ABS_TOL = 1e-5, 0.05  # per-read kernel vs float64 twin
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


def reset_counters():
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    for kid, (name, _src, _rep) in KERNELS.items():
        getattr(T, name).launches = 0
        getattr(T, TWINS[kid]).calls = 0


def read_counters():
    """({kernel id: launches}, {kernel id: twin calls})."""
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    return ({k: getattr(T, name).launches for k, (name, _s, _r) in KERNELS.items()},
            {k: getattr(T, TWINS[k]).calls for k in KERNELS})


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
            entry = (f"log_scorer<RW={k.group(1)},RENORM={k.group(2)}>" if k
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


def phase_mapping(device, params, ds, dbg):
    import numpy as np

    from dbgphmm_tpu_torch.multi_dbg.posterior import StageTimes, generate_mappings

    t0 = time.perf_counter()
    reads = list(ds.reads)
    times = StageTimes(k=dbg.k)
    maps = generate_mappings(dbg, params, reads, device, times=times)
    assert np.isfinite(maps.read_logps).all()
    emit("mapping", t0, reads=len(reads), bases=sum(len(r) for r in reads),
         width=max(n.shape[1] for n in maps.nodes), seed_s=times.seed_s,
         refine_s=times.refine_s)
    return maps


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
    s, dev_s = scorer.chunks[0], scorer._dev[0]
    L, D, Bp, A = s.prevp.shape
    lt = T.lin_params(params, np.float64)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    kw = dict(n_max_gaps=params.n_max_gaps)

    def k1_args(batch, dt):
        eff, total = T._eff_matrix(s, batch)
        return (on(eff, dt), on(T.log_inv_total(total), dt), *dev_s, on(lt, dt))

    def launch_of(eff):
        """The wrapper's (G, TP) for this eff table."""
        return T._pick_log_launch(_build.mapped_scorer_lib(), eff.shape[0],
                                  int(Bp), int(A), int(D), T.live_columns(eff),
                                  2, device)

    def parity(batch, what):
        """The kernel against the float64 twin on one batch; returns the
        kernel's [C, B] float32 result and the max abs error."""
        got = T.mapped_scores_log(*k1_args(batch, torch.float32), **kw)
        ref = T.mapped_scores_log_reference(*k1_args(batch, torch.float64), **kw)
        got_np = got[:, :B].double().cpu().numpy()
        ref_np = ref[:, :B].cpu().numpy()
        err = check_close(got_np, ref_np, what)
        same_best(got_np, ref_np, what)
        return got, err

    # the real case: 16 candidates x 16 reads (the wrapper picks G = 1)
    got, err_real = parity(cands, "real case")
    args32 = k1_args(cands, torch.float32)
    ms_real = cuda_ms(lambda: T.mapped_scores_log(*args32, **kw), 5)
    real = dict(C=len(cands), B=B, L=int(L), A=int(A), D=int(D), NC=s.nc_pad,
                n_live=T.live_columns(args32[0]),
                group_stage=launch_of(args32[0]),
                max_abs_err=err_real, ms=ms_real,
                kernel_scorings_per_s=len(cands) * B / (ms_real / 1e3))

    # the main path's launch shape: the draft's whole neighbourhood (the
    # final pass's batch) on the same reads, the real case's candidates
    # first.  The wrapper picks G = 8; one candidate is dropped if needed
    # so that the last group is partial (its tail rows recompute the last
    # candidate and are not written).
    seen = {tuple(cn) for cn in cands}
    full = cands + [cn for cn, _i in
                    to_neighbor_copy_nums_and_infos(dbg, NeighborConfig())
                    if tuple(cn) not in seen]
    if len(full) % T.MAX_GROUP == 0:
        full.pop()
    args_f = k1_args(full, torch.float32)
    n_live = T.live_columns(args_f[0])
    G_full, TP_full = launch_of(args_f[0])
    assert G_full > 1, f"the wrapper picks G={G_full} for the full batch"
    out_f, err_full = parity(full, "full batch")
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
        eff_s, linv_s, ints = synthetic_case(A_s, 3, NC_s, C=21, B=12, L=2000,
                                             seed=A_s, device=device)
        a32 = (on(eff_s, torch.float32), on(linv_s, torch.float32), *ints,
               on(lt, torch.float32))
        r = T.mapped_scores_log_reference(on(eff_s, torch.float64),
                                          on(linv_s, torch.float64), *ints,
                                          on(lt, torch.float64), **kw)
        r_np = r.cpu().numpy()
        case = dict(A=A_s, D=3, NC=NC_s, C=21)
        for g in (None, T.MAX_GROUP):
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


def phase_parity(kid, device, params, dbg, ctx, genome_size):
    """K2 or K3 against its twin on the real case + the blocked candidate,
    the synthetic cases, and K1's output at the main path's shape."""
    import numpy as np
    import torch

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    t0 = time.perf_counter()
    kernel = getattr(T, KERNELS[kid][0])
    twin = getattr(T, TWINS[kid])
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

    # the real case, 17 candidates x 16 reads, against the float64 twin
    got = kernel(*args(real, torch.float32), **kw)[:, :B].double().cpu().numpy()
    ref = twin(*args(real, torch.float64), **kw)[:, :B].cpu().numpy()
    err_real = check_close(got, ref, f"{kid} real case", underflow_ok=linear)
    same_best(got, ref, f"{kid} real case")
    real_out = dict(C=len(real), B=B, max_abs_err=err_real,
                    blocked_reads_neginf=int(np.isneginf(got[-1]).sum()),
                    blocked_reads_neginf_f64_twin=int(np.isneginf(ref[-1]).sum()))
    if linear:
        # float32 linear underflows on the blocked candidate's reads
        assert np.isneginf(got[-1]).any(), "K3 did not flag the blocked candidate"

    # synthetic cases against the float64 twin; K3 at the picked group and
    # at 8 candidates per block (21 candidates: a partial last group)
    synth, err_max = [], err_real
    groups = (None, T.MAX_GROUP) if linear else (None,)
    for A_s, NC_s in ((16, 256), (64, 384), (128, 256)):
        eff_s, linv_s, ints = synthetic_case(A_s, 3, NC_s, C=21, B=12, L=2000,
                                             seed=A_s, device=device)
        inv_s = np.exp(linv_s) if linear else linv_s
        r_np = twin(on(eff_s, torch.float64), on(inv_s, torch.float64), *ints,
                    on(lt, torch.float64), **kw).cpu().numpy()
        case = dict(A=A_s, D=3, NC=NC_s, C=21)
        a32 = (on(eff_s, torch.float32), on(inv_s, torch.float32), *ints,
               on(lt, torch.float32))
        for g in groups:
            gkw = dict(kw, group=g) if linear else kw
            o_np = kernel(*a32, **gkw).double().cpu().numpy()
            what = f"{kid} synthetic A={A_s} group={g}"
            e = check_close(o_np, r_np, what, underflow_ok=linear)
            same_best(o_np, r_np, what)
            err_max = max(err_max, e)
            case[f"max_abs_err_group_{g or 'picked'}"] = e
        synth.append(case)

    # the main path's shape: against K1's checked output, then the times
    args_f = args(full, torch.float32)
    out_f = kernel(*args_f, **kw)
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
    bnd = bound(kid, len(full), dev_s, T.live_columns(args_f[0]),
                kw["n_max_gaps"], sm_clock_hz(), ctx["n_sm"])
    main = dict(C=len(full), B=B, ms=ms, plain_ms=plain_ms, **bnd,
                share_of_bound=bnd["bound_ms"] / ms,
                max_abs_diff_k1=err_k1,
                n_reads_neginf=int(np.isneginf(got_f).sum()),
                max_abs_diff_f32_twin_real_case=float(
                    np.abs(o32[fin] - t32[fin]).max(initial=0.0)),
                kernel_scorings_per_s=len(full) * B / (ms / 1e3))

    rescue = {}
    if linear:
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
        rescue = dict(rescued=times.n_rescued, likelihood=scores[1].likelihood,
                      k2_launches=launches["K2"], k3_launches=launches["K3"])

    emit(f"{kid.lower()}_parity", t0, real=real_out, synthetic=synth,
         main_shape=main, rescue=rescue)
    return dict(max_abs_err=err_max, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])


def phase_refine(params, ds, dbg, maps98):
    import numpy as np

    from dbgphmm_tpu_torch.multi_dbg.posterior import generate_mappings

    t0 = time.perf_counter()
    reads = list(ds.reads)[:4]
    g = first_reads(maps98, len(reads))
    c = generate_mappings(dbg, params, reads, "cpu")
    cpu_s = time.perf_counter() - t0
    rel = np.abs(g.read_logps - c.read_logps) / np.abs(c.read_logps)
    assert np.isfinite(g.read_logps).all() and rel.max() <= 1e-4, rel.max()
    same = total = 0
    for a, b in zip(g.nodes, c.nodes):
        has = (a[:, 0] >= 0) | (b[:, 0] >= 0)
        same += int((a[:, 0] == b[:, 0])[has].sum())
        total += int(has.sum())
    assert same >= 0.99 * total, (same, total)
    emit("refine", t0, reads=len(reads), bases=sum(len(r) for r in reads),
         cpu_f64_s=cpu_s, max_rel_logp_diff=float(rel.max()),
         top1_agree=same / max(total, 1))


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
    return out


def phase_inspect(device, ds, dbg):
    import numpy as np

    from dbgphmm_tpu_torch.phmm.template import make_template
    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.ops.forward import pad_reads
    from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions

    t0 = time.perf_counter()
    # observe the mapping the CLI builds, to score its two candidates by K1
    seen = []
    real_generate = TP.generate_mappings

    def recording(*a, **kw):
        seen.append(real_generate(*a, **kw))
        return seen[-1]

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["inspect", "-d", str(ROOT / "data/bench/data.dbg"),
                str(ROOT / "data/bench/data.json"), "-o",
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
    emit("inspect", t0, argv=argv[:1], k2_launches=launches["K2"], **out)
    return launches["K2"]


def phase_infer():
    import numpy as np

    from dbgphmm_tpu_torch import cli

    from dbgphmm_tpu_torch.multi_dbg import posterior as TP
    from dbgphmm_tpu_torch.ops import mapped_scorer as T

    t0 = time.perf_counter()
    # K1 launches of each stage's climb: the counter read around each
    # sample_posterior call (one per k-stage and one for the final pass)
    per_stage = []
    real_sample = TP.sample_posterior

    def counting(dbg, *a, **kw):
        n0 = T.mapped_scores_log.launches
        post = real_sample(dbg, *a, **kw)
        per_stage.append(dict(k=dbg.k, k1_launches=T.mapped_scores_log.launches - n0,
                              samples=len(post.samples)))
        return post

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "out")
        argv = ["sim-infer", str(ROOT / "data/bench/data.json"),
                "-d", str(ROOT / "data/bench/data.dbg"), "-o", prefix,
                "-K", "41", "-I", "1"]
        TP.sample_posterior = counting
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
        launches, twins = read_counters()
        assert launches["K1"] > 0, "the K1 kernel never ran on the main path"
        assert not any(twins.values()), f"a twin ran on CUDA: {twins}"
        lls = np.asarray([s.score.likelihood for s in post.samples])
        assert not np.isnan(lls).any(), "NaN likelihood"
        files = sorted(os.listdir(tmp))
        for k in (40, 41):
            for ext in ("dbg", "map.mpz", "post", "gfa", "inspect"):
                assert f"out.k{k}.{ext}" in files, f"missing out.k{k}.{ext}"
        assert "out.final.euler.fa" in files
        tail = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("# assembled=")]
    assert sum(st["k1_launches"] for st in per_stage) == launches["K1"]
    emit("infer", t0, argv=argv[:1] + argv[4:], launches=launches["K1"],
         k1_launches_per_stage=per_stage,
         twin_calls=twins["K1"], final_k=dbg.k, n_samples=len(lls),
         n_finite=int(np.isfinite(lls).sum()), result=tail,
         stages=[st.as_dict() for st in stages])
    return launches["K1"]


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
             for stem in ("libmapped_scorer", "libmapped_scorer_linear")}
    emit("build", t1, k1_k2_nvcc_s=log["libmapped_scorer"]["seconds"],
         k3_nvcc_s=log["libmapped_scorer_linear"]["seconds"],
         host_gxx_s={n: log[f"lib{n}"]["seconds"] for n in _build.HOST_LIBS},
         ptxas=ptxas)

    device = torch.device("cuda")
    params = PHMMParams.uniform(0.001)  # the CLI's default --p-error
    ds = Dataset.from_json_file(ROOT / "data/bench/data.json")
    dbg = out.from_dbg_file(ROOT / "data/bench/data.dbg")
    maps98 = phase_mapping(device, params, ds, dbg)
    res = {}
    res["K1"], ctx = phase_k1_parity(device, params, ds, dbg, maps98)
    ctx["blocked"] = blocked_candidate(device, ctx)
    for kid in ("K2", "K3"):
        res[kid] = phase_parity(kid, device, params, dbg, ctx, ds.genome_size())
    del ctx
    phase_refine(params, ds, dbg, maps98)
    spaces = phase_scorer_spaces(device, params, ds, dbg, maps98)
    launches = {"K2": phase_inspect(device, ds, dbg),
                "K3": spaces["linear"]["launches"]["K3"],
                "K1": phase_infer()}
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dbgphmm_tpu"))
    assert not foreign, f"the port imported {foreign[:5]}"

    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[kid], "max_abs_err": res[kid]["max_abs_err"],
        "ms": res[kid]["ms"], "plain_ms": res[kid]["plain_ms"],
        "bound_ms": res[kid]["bound_ms"], "bound_by": res[kid]["bound_by"],
        # no single PyTorch call computes a profile-HMM forward
        "library_ms": None,
    } for kid, (name, src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
