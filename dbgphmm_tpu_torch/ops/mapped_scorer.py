"""Candidate scorer over mapped read streams: host stream build, the three
CUDA kernels' wrappers, their plain PyTorch twins, and the scorer class.

Counterpart of ``dbgphmm_tpu/ops/pallas_mapped.py``.  That module imports
JAX, so its numpy host code is copied here rather than imported:
``MappedStreams``/``build_streams`` (:149), ``_eff_matrix`` (:265),
``eff_tables`` (:291) and the read sort, read chunking, degree unification
and NC trim of ``PallasMappedScorer.__init__`` (:1342-1470).

The kernels, each the Hopper port of a Pallas kernel, with its twin:

    K1 mapped_scores_log         _make_kernel_log_packed (:718)  csrc/mapped_scorer.cu
    K2 mapped_scores_log_single  _make_kernel_log (:488)         csrc/mapped_scorer.cu
    K3 mapped_scores_linear      _make_kernel (:298)             csrc/mapped_scorer_linear.cu

For tensors on the CPU a wrapper runs its twin (``*_reference``), the same
recursion in plain PyTorch; for CUDA tensors it launches the kernel or
raises.  ``MappedScorer(mesh=)`` takes the place of the two ``shard_map``
wrappers (``pallas_mapped_scores_sharded`` :1234,
``pallas_mapped_scores_packed_sharded`` :1276): one launch per shard and
read chunk on the shard's device.  The TPU-only machinery of the Pallas
scorer (lane packing P, the CL / vmem_div back-off ladder, the launch
watchdog, crash dumps) has no counterpart here.

Stream layouts (position-major, the D axis split out):

    codes   [L, B]          read bases (-1 = padding)
    emis    [L, B, A]       emission code per slot (9 = empty slot)
    numce   [L, B, A]       compact edge id of the slot (sentinel NC-1, eff 0)
    selfp   [L, B, A]       slot of this node at the previous position
    prevp   [L, D, B, A]    slot of parent d at the previous position
    curp    [L, D, B, A]    slot of parent d at the same position
    dence   [L, D, B, A]    compact ids of the source node's out-edges
"""

from __future__ import annotations

import copy
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.sharding import gather_to_host, local_mesh, put_replicated
from . import _build
from .forward import default_dtype

NEGF = -1e30  # finite log(0) sentinel of the kernel (and of the TPU kernel)
RENORM_EVERY = 2  # renormalise every 2 positions (the TPU production value)
MAX_ROWS = 8  # candidate rows per block, at most (MAX_ROWS in the kernels)
# read positions staged per copy: the block meets once per copy, so never
# one (a block barrier at every position)
STAGE_POSITIONS = (8, 4, 2)


class MappedStreams(NamedTuple):
    codes: np.ndarray  # [L, B]
    emis: np.ndarray  # [L, B, A]
    numce: np.ndarray  # [L, B, A]
    selfp: np.ndarray  # [L, B, A]
    prevp: np.ndarray  # [L, D, B, A]
    curp: np.ndarray  # [L, D, B, A]
    dence: np.ndarray  # [L, D, B, A]
    lens: np.ndarray  # [B] int32
    nc_pad: int  # padded compact-edge table width (sentinel = nc_pad-1)
    emittable_len: np.ndarray  # [nc_pad] f32: #emittable kmers per compact edge
    # NC trim: when set, numce/dence hold LOCAL ids into ce_ids (the compact
    # edges this read chunk references) and eff tables are eff[cn][ce_ids];
    # the normalising total still comes from the full assignment.
    ce_ids: np.ndarray = None  # [n_used] int32 global compact ids, or None
    emittable_len_full: np.ndarray = None  # [nc] f32 (global)


def build_streams(template, positions, codes: np.ndarray, lens: np.ndarray,
                  b_pad: int = 8, a_pad: int = 16) -> MappedStreams:
    """Host-side stream construction from a PHMMTemplate + MappedPositions.

    The slot width is bucketed to the next power of two >= max(a_pad, A0);
    structurally empty trailing degree columns are dropped."""
    mn = positions.map_nodes  # [B, L, A0]
    B, L, A0 = mn.shape
    D = template.parent_idx.shape[1]
    A = max(a_pad, 1 << max(0, (A0 - 1)).bit_length())
    Bp = -(-B // b_pad) * b_pad

    f2c = template.full_to_compact.astype(np.int32)
    nc = int(f2c.max()) + 1 if f2c.size else 1
    nc_pad = max(128, 1 << (nc + 1).bit_length())
    SENT = nc_pad - 1

    emit_ok = template.emittable
    num_tab = np.where(emit_ok, f2c, SENT).astype(np.int32)
    # child edges of the SOURCE node of each edge = sibling out-edges:
    # stable-sort emittable edges by source node, place each at its rank
    src_out = np.full((template.n_nodes_graph, D), SENT, dtype=np.int32)
    ee = np.nonzero(emit_ok)[0]
    order = np.argsort(template.src_node[ee], kind="stable")
    ee = ee[order]
    srcs = template.src_node[ee]
    first = np.ones(len(ee), dtype=bool)
    first[1:] = srcs[1:] != srcs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(ee)), 0))
    rank = np.arange(len(ee)) - run_start
    keep = rank < D
    src_out[srcs[keep], rank[keep]] = f2c[ee[keep]]
    den_tab = src_out[template.src_node]  # [n, D]

    emit_code = np.where(emit_ok, template.emission.astype(np.int32), 9)

    # narrow host dtypes (slot ids fit int8 for A <= 128, compact ids int16
    # up to nc_pad = 32768); the device copies are int32
    slot_dt = np.int8 if A <= 128 else np.int16
    ce_dt = np.int16 if nc_pad <= 32768 else np.int32

    def pad_BA(arr, fill, dt=slot_dt):
        out = np.full((L, Bp, A), fill, dtype=dt)
        out[:, :B, :A0] = arr
        return out

    mnT = np.swapaxes(mn, 0, 1)  # [L, B, A0]
    ok = mnT >= 0
    safe = np.where(ok, mnT, 0)

    emis = pad_BA(np.where(ok, emit_code[safe], 9), 9)
    numce = pad_BA(np.where(ok, num_tab[safe], SENT), SENT, dt=ce_dt)
    selfp = pad_BA(np.swapaxes(positions.self_pos, 0, 1), -1)

    prevp = np.full((L, D, Bp, A), -1, dtype=slot_dt)
    curp = np.full((L, D, Bp, A), -1, dtype=slot_dt)
    dence = np.full((L, D, Bp, A), SENT, dtype=ce_dt)
    ppT = np.swapaxes(positions.prev_pos, 0, 1)  # [L, B, A0, D]
    cpT = np.swapaxes(positions.cur_pos, 0, 1)
    den_g = np.where(ok[..., None], den_tab[safe], SENT)  # [L, B, A0, D]
    for d in range(D):
        prevp[:, d, :B, :A0] = ppT[:, :, :, d]
        curp[:, d, :B, :A0] = cpT[:, :, :, d]
        dence[:, d, :B, :A0] = den_g[:, :, :, d]

    # drop structurally empty trailing degree columns (the template pads the
    # degree to the {2, 5} bucket; real DBG parent degree is mostly 2-3)
    d_used = 1
    for d in range(D - 1, 0, -1):
        if (prevp[:, d] >= 0).any() or (curp[:, d] >= 0).any() or (
            dence[:, d] != SENT
        ).any():
            d_used = d + 1
            break
    if d_used < D:
        prevp = np.ascontiguousarray(prevp[:, :d_used])
        curp = np.ascontiguousarray(curp[:, :d_used])
        dence = np.ascontiguousarray(dence[:, :d_used])

    codes_T = np.full((L, Bp), -1, dtype=np.int8)
    codes_T[:, :B] = np.swapaxes(codes, 0, 1)
    lens_p = np.zeros(Bp, dtype=np.int32)
    lens_p[:B] = lens

    # emittable kmer count per compact edge (for the normalising total)
    el = np.zeros(nc_pad, dtype=np.float32)
    np.add.at(el, f2c[emit_ok], 1.0)
    el[SENT] = 0.0

    return MappedStreams(
        codes=codes_T, emis=emis, numce=numce, selfp=selfp,
        prevp=prevp, curp=curp, dence=dence, lens=lens_p,
        nc_pad=nc_pad, emittable_len=el,
        emittable_len_full=el[:nc].copy(),
    )


def _eff_matrix(streams: MappedStreams, cands) -> Tuple[np.ndarray, np.ndarray]:
    """(eff [C, nc_pad] f32 in the stream's id space, total [C] f64).

    With the NC trim (streams.ce_ids) the eff columns are eff[cn][ce_ids];
    the normalising total is always over the full assignment."""
    C, nc = len(cands), streams.emittable_len_full.shape[0]
    cn_mat = np.zeros((C, nc), dtype=np.float32)
    for c, cn in enumerate(cands):
        cn_mat[c, : len(cn)] = np.asarray(cn, dtype=np.float32)
    total = cn_mat @ streams.emittable_len_full
    eff = np.zeros((C, streams.nc_pad), dtype=np.float32)
    if streams.ce_ids is not None:
        eff[:, : len(streams.ce_ids)] = cn_mat[:, streams.ce_ids]
    else:
        eff[:, :nc] = cn_mat  # nc < nc_pad - 1: the sentinel column stays 0
    return eff, total


def live_columns(eff: torch.Tensor) -> int:
    """[C, NC] eff table -> its columns up to the last one that is non-zero
    for some candidate (at least 1).  The kernels stage only these, and read
    every compact id past them as a copy number of 0."""
    nz = eff.ne(0).any(dim=0).nonzero()
    return int(nz[-1]) + 1 if nz.numel() else 1


def eff_tables(streams: MappedStreams, copy_num_candidates
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-candidate linear copy-number tables + 1/total_eff."""
    eff, total = _eff_matrix(streams, copy_num_candidates)
    return eff, lin_inv_total(total).astype(np.float32)[:, None]


def lin_inv_total(total: np.ndarray) -> np.ndarray:
    """1 / total, 0 for an empty assignment (K3's ``inv_total``), in
    float64."""
    total = np.asarray(total, dtype=np.float64)
    return np.where(total > 0, 1.0 / np.maximum(total, 1e-30), 0.0)


def log_inv_total(total: np.ndarray) -> np.ndarray:
    """log(1 / total), with the NEGF sentinel for an empty assignment (the
    kernel's ``linv``), computed in float64."""
    total = np.asarray(total, dtype=np.float64)
    return np.where(total > 0, -np.log(np.maximum(total, 1e-30)), NEGF)


def lin_params(params, dtype=np.float32) -> np.ndarray:
    """The 13 linear transition/emission probabilities in LinTrans order."""
    lg = params.log_transitions()
    order = ["p_MM", "p_IM", "p_DM", "p_MI", "p_II", "p_DI", "p_MD", "p_ID",
             "p_DD", "p_match", "p_mismatch", "p_random", "p_end"]
    return np.asarray([np.exp(lg[k]) for k in order], dtype=dtype)


# -- the plain PyTorch twin ---------------------------------------------------


def _ladd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return mx + torch.log1p(torch.exp(torch.clamp(mn - mx, min=NEGF)))


def mapped_scores_log_reference(eff, linv, lens, codes, emis, numce, selfp,
                                prevp, curp, dence, lt_lin, n_max_gaps: int = 4
                                ) -> torch.Tensor:
    """Plain PyTorch version of the K1 kernel: the same recursion, for all
    candidates and reads at once, in ``eff.dtype`` on ``eff.device``.

    eff [C, NC]; linv [C] = log(1/total); lens [B]; streams as in the module
    docstring; lt_lin [13] linear probabilities.  Returns [C, B] per-read
    log-likelihoods (-inf where the read is unexplainable)."""
    mapped_scores_log_reference.calls += 1
    return _log_recursion(eff, linv, lens, codes, emis, numce, selfp, prevp,
                          curp, dence, lt_lin, n_max_gaps, RENORM_EVERY)


mapped_scores_log_reference.calls = 0


def mapped_scores_log_single_reference(eff, linv, lens, codes, emis, numce,
                                       selfp, prevp, curp, dence, lt_lin,
                                       n_max_gaps: int = 4) -> torch.Tensor:
    """Plain PyTorch version of the K2 kernel (the TPU's ``_make_kernel_log``):
    K1's recursion renormalised at every position.  Arguments and result as
    :func:`mapped_scores_log_reference`.

    The TPU kernel carries the Begin chain as renormalised log scalars and
    shifts by the M maximum alone; that loses whole nats in float32 (ROADMAP
    "Faults found").  Like K1, this computes the chain in closed form and
    shifts by the largest live state; the end state comes once from the
    frozen tables, the value the TPU kernel reaches by recomputing it at
    every valid step."""
    mapped_scores_log_single_reference.calls += 1
    return _log_recursion(eff, linv, lens, codes, emis, numce, selfp, prevp,
                          curp, dence, lt_lin, n_max_gaps, 1)


mapped_scores_log_single_reference.calls = 0


def _log_recursion(eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
                   dence, lt_lin, n_max_gaps: int, renorm_every: int
                   ) -> torch.Tensor:
    dt, dev = eff.dtype, eff.device
    C = eff.shape[0]
    L, D, B, A = prevp.shape
    lg = torch.log(torch.clamp(lt_lin.to(device=dev, dtype=dt), min=1e-38))
    (lMM, lIM, lDM, lMI, lII, lDI, lMD, lID, lDD,
     l_match, l_mismatch, l_random, l_end) = lg.unbind()
    full = lambda shape, v: torch.full(shape, v, dtype=dt, device=dev)
    m = i = d = full((C, B, A), NEGF)
    off, off_c = full((C, B, 1), 0.0), full((C, B, 1), 0.0)
    # closed-form Begin chain (see the kernel): after position t the
    # Begin-insert state is lB0 + t * lBstep, absolute
    lB0, lBstep = l_random + lMI, l_random + lII
    linv_c = linv.to(dt).reshape(C, 1, 1)

    def gather(tab, idx):
        out = torch.gather(tab, 2, idx.clamp(min=0).expand(C, B, A))
        return torch.where(idx >= 0, out, NEGF)

    def gather_deg(tab, idxs):
        out = gather(tab, idxs[0])
        for idx in idxs[1:]:
            out = _ladd(out, gather(tab, idx))
        return out

    n_steps = int(lens.max()) if B else 0
    for t in range(n_steps):
        valid = (t < lens).reshape(1, B, 1)
        x = codes[t].long()
        em = emis[t].long()
        l_emit = torch.where(em == x[:, None], l_match, l_mismatch)
        l_emit = torch.where(em < 4, l_emit, NEGF)
        num = eff[:, numce[t].long()]
        den = eff[:, dence[t, 0].long()]
        for dd in range(1, D):
            den = den + eff[:, dence[t, dd].long()]
        ok_t = (num > 0) & (den > 0)
        l_num = torch.log(torch.clamp(num, min=1e-38))
        l_tval = torch.where(ok_t, l_num - torch.log(torch.clamp(den, min=1e-38)),
                             NEGF)
        l_init = torch.where(num > 0, l_num + linv_c, NEGF)
        pp = [prevp[t, dd].long() for dd in range(D)]
        cp = [curp[t, dd].long() for dd in range(D)]
        base = off - off_c
        if t == 0:
            mb, ib = full((C, B, 1), 0.0), full((C, B, 1), NEGF)
        else:
            mb, ib = full((C, B, 1), NEGF), (lB0 + (t - 1) * lBstep) - base

        pre_m = _ladd(_ladd(lMM + m, lIM + i), lDM + d)
        inner = gather_deg(pre_m, pp)
        from_begin = l_init + _ladd(lMM + mb, lIM + ib)
        m_new = l_emit + _ladd(l_tval + inner, from_begin)
        pre_i = _ladd(_ladd(lMI + m, lII + i), lDI + d)
        i_new = l_random + gather(pre_i, selfp[t].long())
        mb_new = full((C, B, 1), NEGF)
        ib_new = (lB0 + t * lBstep) - base

        pre_d = _ladd(lMD + m_new, lID + i_new)
        acc = gather_deg(pre_d, cp)
        d_new = _ladd(l_tval + acc, l_init + _ladd(lMD + mb_new, lID + ib_new))
        fdt = d_new
        for _ in range(n_max_gaps):
            fdt = l_tval + lDD + gather_deg(fdt, cp)
            d_new = _ladd(d_new, fdt)

        off_new, off_c_new = off, off_c
        if t % renorm_every == renorm_every - 1:
            # the largest live state (see the kernel): M, I, D, Begin chain
            shift = torch.maximum(torch.maximum(m_new, i_new), d_new)
            shift = torch.maximum(shift.amax(dim=-1, keepdim=True), ib_new)
            shift = torch.where((shift > NEGF / 2) & valid, shift, 0.0)
            m_new = torch.clamp(m_new - shift, min=NEGF)
            i_new = torch.clamp(i_new - shift, min=NEGF)
            d_new = torch.clamp(d_new - shift, min=NEGF)
            y = shift - off_c
            off_new = off + y
            off_c_new = (off_new - off) - y
        m = torch.where(valid, m_new, m)
        i = torch.where(valid, i_new, i)
        d = torch.where(valid, d_new, d)
        off = torch.where(valid, off_new, off)
        off_c = torch.where(valid, off_c_new, off_c)

    # end state from the frozen tables: log P = l_end + lse(M+I+D) + offset
    mid = _ladd(_ladd(m, i), d)
    mx = torch.clamp(mid.amax(dim=-1, keepdim=True), min=NEGF)
    lse = mx + torch.log(torch.exp(torch.clamp(mid - mx, min=NEGF))
                         .sum(dim=-1, keepdim=True))
    score = torch.where(lse > NEGF / 2, l_end + lse + (off - off_c),
                        float("-inf"))
    return score[..., 0]


def mapped_scores_linear_reference(eff, inv_total, lens, codes, emis, numce,
                                   selfp, prevp, curp, dence, lt_lin,
                                   n_max_gaps: int = 4) -> torch.Tensor:
    """Plain PyTorch version of the K3 kernel (the TPU's ``_make_kernel``,
    the scaled-linear form of ``ops/sparse.py:_s_step_lin``), op for op, for
    all candidates and reads at once, in ``eff.dtype`` on ``eff.device``.

    Tables are linear and multiply-add only; every position scales them by
    the M maximum and adds its log to a Kahan-summed offset.  inv_total [C]
    is the LINEAR 1/total (0 for an empty assignment); the other arguments
    and the result as :func:`mapped_scores_log_reference`.  A read forced
    across a copy-0 edge underflows to -inf here where the log-space
    recursions stay finite; ``MappedScorer`` flags it for the rescue."""
    mapped_scores_linear_reference.calls += 1
    dt, dev = eff.dtype, eff.device
    C = eff.shape[0]
    L, D, B, A = prevp.shape
    (pMM, pIM, pDM, pMI, pII, pDI, pMD, pID, pDD,
     p_match, p_mismatch, p_random, p_end) = lt_lin.to(device=dev, dtype=dt).unbind()
    zeros = lambda shape: torch.zeros(shape, dtype=dt, device=dev)
    m = i = d = zeros((C, B, A))
    mb, ib = torch.ones((C, B, 1), dtype=dt, device=dev), zeros((C, B, 1))
    off, off_c = zeros((C, B, 1)), zeros((C, B, 1))
    invt = inv_total.to(dt).reshape(C, 1, 1)

    def gather_sum(tab, idxs):
        out = None
        for idx in idxs:
            g = torch.gather(tab, 2, idx.clamp(min=0).expand(C, B, A))
            g = torch.where(idx >= 0, g, 0.0)
            out = g if out is None else out + g
        return out

    n_steps = int(lens.max()) if B else 0
    for t in range(n_steps):
        valid = (t < lens).reshape(1, B, 1)
        x = codes[t].long()
        em = emis[t].long()
        num = eff[:, numce[t].long()]
        den = eff[:, dence[t, 0].long()]
        for dd in range(1, D):
            den = den + eff[:, dence[t, dd].long()]
        t_val = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
        init_p = num * invt
        p_emit = torch.where(em == x[:, None], p_match, p_mismatch)
        p_emit = torch.where(em < 4, p_emit, 0.0)
        pp = [prevp[t, dd].long() for dd in range(D)]
        cp = [curp[t, dd].long() for dd in range(D)]

        inner = gather_sum(pMM * m + pIM * i + pDM * d, pp)
        from_begin = init_p * (pMM * mb + pIM * ib)
        m_new = p_emit * (t_val * inner + from_begin)
        i_new = p_random * gather_sum(pMI * m + pII * i + pDI * d,
                                      [selfp[t].long()])
        mb_new = torch.zeros_like(mb)
        ib_new = p_random * (pMI * mb + pII * ib)

        acc = gather_sum(pMD * m_new + pID * i_new, cp)
        d_new = t_val * acc + init_p * (pMD * mb_new + pID * ib_new)
        fdt = d_new
        for _ in range(n_max_gaps):
            fdt = t_val * (pDD * gather_sum(fdt, cp))
            d_new = d_new + fdt

        scale = m_new.amax(dim=-1, keepdim=True)
        scale = torch.where((scale > 0) & valid, scale, 1.0)
        inv = 1.0 / scale
        m_new, i_new, d_new = m_new * inv, i_new * inv, d_new * inv
        ib_new = ib_new * inv
        y = torch.log(scale) - off_c
        tt = off + y
        off_c_new = (tt - off) - y
        m = torch.where(valid, m_new, m)
        i = torch.where(valid, i_new, i)
        d = torch.where(valid, d_new, d)
        mb = torch.where(valid, mb_new, mb)
        ib = torch.where(valid, ib_new, ib)
        off = torch.where(valid, tt, off)
        off_c = torch.where(valid, off_c_new, off_c)

    # end state from the frozen tables (the TPU kernel recomputes it at
    # every valid step): P = p_end * sum(M + I + D) * exp(offset)
    e = p_end * (m + i + d).sum(dim=-1, keepdim=True)
    score = torch.where(e > 0, torch.log(torch.where(e > 0, e, 1.0)) + off,
                        float("-inf"))
    return score[..., 0]


mapped_scores_linear_reference.calls = 0


# -- the kernels --------------------------------------------------------------


def _check_inputs(where, eff, inv, lens, codes, emis, numce, selfp, prevp,
                  curp, dence, lt_lin):
    dev = eff.device
    if dev.type != "cuda":
        raise ValueError(f"{where} runs on cpu or cuda, not {dev}")
    named = dict(eff=eff, inv=inv, lens=lens, codes=codes, emis=emis,
                 numce=numce, selfp=selfp, prevp=prevp, curp=curp,
                 dence=dence, lt_lin=lt_lin)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, eff on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
        want = torch.float32 if name in ("eff", "inv", "lt_lin") else torch.int32
        if t.dtype != want:
            raise ValueError(f"{where}: {name} must be {want}, got {t.dtype}")
    C, NC = eff.shape
    L, D, B, A = prevp.shape
    shapes = dict(inv=(C,), lens=(B,), codes=(L, B), emis=(L, B, A),
                  numce=(L, B, A), selfp=(L, B, A), curp=(L, D, B, A),
                  dence=(L, D, B, A), lt_lin=(13,))
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{where}: {name} has shape "
                             f"{tuple(named[name].shape)}, expected {shape}")
    if not 1 <= D <= 5 or not 1 <= A <= 1024:
        raise ValueError(f"{where}: unsupported degree D={D} or width A={A}")


# The kernels' C entries, one per kernel, each with its occupancy entry
# <entry>_blocks_per_sm (csrc/mapped_common.cuh, DBG_SCORER_ENTRIES).
ENTRIES = {"K1": (_build.mapped_scorer_lib, "dbg_mapped_scores_log"),
           "K2": (_build.mapped_scorer_lib, "dbg_mapped_scores_log_single"),
           "K3": (_build.mapped_scorer_linear_lib, "dbg_mapped_scores_linear")}


class Launch(NamedTuple):
    """One launch of a scorer kernel, as :func:`launch_plan` derives it."""
    group: int  # candidate rows per block
    stage: int  # read positions staged per copy
    blocks_per_sm: int  # resident blocks per SM the runtime reports
    n_live: int  # eff columns staged (:func:`live_columns`)


def _pick_launch(blocks_per_sm, C: int, B: int, n_sm: int,
                 group: Optional[int] = None) -> Tuple[int, int, int]:
    """(rows per block G, positions staged per copy TP, resident blocks per
    SM) of a launch over C candidates and B reads.

    ``blocks_per_sm(G, TP)`` is the kernel's occupancy (0: it does not
    fit).  For each G in 1, 2, 4, ..., MAX_ROWS (or the forced ``group``)
    and each TP: the most candidate rows resident on the card at once
    (where C < G, only C rows of a block count), then the most busy SMs,
    then the deeper stage, then the fewer rows per block."""
    groups = [group] if group else [1 << i for i in range(MAX_ROWS.bit_length())]
    best = None
    for G in groups:
        n_blocks = -(-C // G) * B
        for TP in STAGE_POSITIONS:
            per_sm = blocks_per_sm(G, TP)
            if per_sm <= 0:
                continue
            rows = min(per_sm * n_sm, n_blocks) * min(G, C)
            key = (rows, min(n_blocks, n_sm), TP, -G)
            if best is None or key > best[0]:
                best = (key, G, TP, per_sm)
    if best is None:
        raise ValueError(f"no launch of the scorer fits an SM (group={group})")
    return best[1:]


def launch_plan(kid: str, eff: torch.Tensor, prevp: torch.Tensor,
                group: Optional[int] = None) -> Launch:
    """The launch of kernel ``kid`` ("K1", "K2", "K3") for this eff table
    and these streams, as the wrapper makes it."""
    lib_of, entry = ENTRIES[kid]
    C, NC = eff.shape
    L, D, B, A = prevp.shape
    ncl = live_columns(eff)
    if ncl >= NC:
        raise ValueError(f"{kid}: eff's sentinel column {NC - 1} must be 0")
    if A > 128 or A % 4:
        raise ValueError(f"{kid}: slot width A={A} must be a multiple of 4 "
                         "and at most 128")
    per_sm = getattr(lib_of(), entry + "_blocks_per_sm")
    n_sm = torch.cuda.get_device_properties(eff.device).multi_processor_count
    try:
        G, TP, n = _pick_launch(lambda g, tp: per_sm(ncl, A, D, g, tp), C, B,
                                n_sm, group)
    except ValueError as e:
        raise ValueError(f"{kid}: {e} (A={A} D={D} n_live={ncl})") from None
    return Launch(G, TP, n, ncl)


def live_degree_columns(prevp: torch.Tensor, curp: torch.Tensor,
                        dence: torch.Tensor, n_live: int) -> torch.Tensor:
    """[L, B] int32: per read position, how many leading degree columns any
    slot uses (1..D): a parent at the previous or the current position, or
    an out-edge id below ``n_live``.  The kernels run a position with only
    as many columns as this says; the rest hold nothing there."""
    L, D, B, A = prevp.shape
    if D == 1:
        return torch.ones((L, B), dtype=torch.int32, device=prevp.device)
    live = ((prevp[:, 1:] >= 0) | (curp[:, 1:] >= 0)
            | (dence[:, 1:] < n_live)).any(dim=-1)  # [L, D-1, B]
    col = torch.arange(2, D + 1, dtype=torch.int32,
                       device=prevp.device).view(1, D - 1, 1)
    return (live.to(torch.int32) * col).amax(dim=1).clamp_(min=1).contiguous()


def _run(kid: str, wrapper, twin, args, n_max_gaps: int,
         group: Optional[int]) -> torch.Tensor:
    """Kernel ``kid`` on ``args``: its twin for CPU tensors; for CUDA
    tensors a launch on the current stream (counted on ``wrapper``), or an
    error with the CUDA error string if the launch is refused.  The eff
    columns to stage, the live degree columns per position and the launch
    shape are derived here from the inputs, so they cannot disagree with
    them."""
    if args[0].device.type == "cpu":
        return twin(*args, n_max_gaps=n_max_gaps)
    _check_inputs(wrapper.__name__, *args)
    eff, prevp, curp, dence = args[0], args[7], args[8], args[9]
    for t in args[2:10]:
        if t.data_ptr() % 16:
            raise ValueError(f"{kid}: streams must be 16-byte aligned")
    plan = launch_plan(kid, eff, prevp, group)
    ncols = live_degree_columns(prevp, curp, dence, plan.n_live)
    lib_of, entry = ENTRIES[kid]
    lib = lib_of()
    C, NC = eff.shape
    L, D, B, A = prevp.shape
    out = torch.empty((C, B), dtype=torch.float32, device=eff.device)
    with torch.cuda.device(eff.device):
        stream = torch.cuda.current_stream(eff.device).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in (*args[:10], ncols, args[10], out)]
        rc = getattr(lib, entry)(*ptrs, C, NC, plan.n_live, L, B, A, D,
                                 n_max_gaps, plan.group, plan.stage,
                                 ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{kid} launch failed: {lib.dbg_cuda_error_string(rc).decode()} "
            f"(C={C} B={B} L={L} A={A} D={D} NC={NC} {plan})")
    wrapper.launches += 1
    return out


def mapped_scores_log(eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
                      dence, lt_lin, n_max_gaps: int = 4,
                      group: Optional[int] = None) -> torch.Tensor:
    """K1: [C, B] per-read log P(read | candidate), rows in candidate order,
    renormalised every 2 positions.

    CUDA tensors (eff/linv/lt_lin float32, streams and lens int32, all
    contiguous on one device; the slot width A a multiple of 4, at most
    128) launch the K1 kernel on the current stream; CPU tensors run
    :func:`mapped_scores_log_reference`.  ``group`` forces the number of
    candidates per block; the result is the same for every group.  Column
    NC - 1 of eff (the sentinel) must be 0; the kernel stages each
    candidate's table only up to its last column that is non-zero for some
    candidate."""
    return _run("K1", mapped_scores_log, mapped_scores_log_reference,
                (eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
                 dence, lt_lin), n_max_gaps, group)


mapped_scores_log.launches = 0


def mapped_scores_log_single(eff, linv, lens, codes, emis, numce, selfp,
                             prevp, curp, dence, lt_lin, n_max_gaps: int = 4,
                             group: Optional[int] = None) -> torch.Tensor:
    """K2: the same quantity as :func:`mapped_scores_log`, renormalised at
    every position.

    CUDA tensors launch the K2 kernel (``dbg_mapped_scores_log_single`` of
    ``csrc/mapped_scorer.cu``); CPU tensors run
    :func:`mapped_scores_log_single_reference`.  Inputs and ``group`` as in
    :func:`mapped_scores_log`."""
    return _run("K2", mapped_scores_log_single,
                mapped_scores_log_single_reference,
                (eff, linv, lens, codes, emis, numce, selfp, prevp, curp,
                 dence, lt_lin), n_max_gaps, group)


mapped_scores_log_single.launches = 0


def mapped_scores_linear(eff, inv_total, lens, codes, emis, numce, selfp,
                         prevp, curp, dence, lt_lin, n_max_gaps: int = 4,
                         group: Optional[int] = None) -> torch.Tensor:
    """K3: [C, B] per-read log P(read | candidate) by the scaled-linear
    recursion; -inf where float32 underflows (reads forced across copy-0
    edges).  ``inv_total`` is the linear 1/total.

    CUDA tensors launch the K3 kernel (``csrc/mapped_scorer_linear.cu``);
    CPU tensors run :func:`mapped_scores_linear_reference`.  Other inputs
    and ``group`` as in :func:`mapped_scores_log`."""
    return _run("K3", mapped_scores_linear, mapped_scores_linear_reference,
                (eff, inv_total, lens, codes, emis, numce, selfp, prevp, curp,
                 dence, lt_lin), n_max_gaps, group)


mapped_scores_linear.launches = 0


# -- the scorer ---------------------------------------------------------------


SPACES = ("packed", "log", "linear")


class MappedScorer:
    """Candidate scorer for one (k, mapping).  ``space`` picks the kernel,
    as ``PallasMappedScorer(space=)`` does in the JAX package: "packed"
    (K1, the default), "log" (K2) or "linear" (K3).  On CUDA the kernel
    runs, on the CPU its twin (float64).

    Built once per k-stage from a PHMMTemplate and the mapping's
    MappedPositions; every call scores a batch of compact-edge copy-number
    assignments.  Reads are sorted for genome locality (and by width bucket,
    so that read chunks stay width-homogeneous), chunked to bound the
    device stream footprint, and each chunk's compact-edge ids are trimmed
    to the ones it references.  Each chunk's result is cut to the batch's
    candidate count before the chunks are joined.

    ``mesh`` (a :class:`~dbgphmm_tpu_torch.parallel.Mesh`, the counterpart
    of ``PallasMappedScorer(mesh=)`` and its two ``shard_map`` wrappers;
    default the 1 x 1 mesh of ``device``): each read chunk is split along
    the mesh's "reads" axis into blocks of a multiple of 8 reads (``b_pad
    = 8 R``), and each block's streams are built and uploaded once, at
    construction, to the devices of the shards that read it (under
    ``torch.distributed``, only by the rank that holds them).  Each call splits the candidates along "cand"
    (padded to a multiple of its size with copies of candidate 0), launches
    the kernel once per shard and read chunk on the shard's device — every
    launch before the first copy to the host — and gathers the [C, B]
    blocks in the original read order.  A block with no read, or a
    candidate row group of padding only, launches nothing."""

    def __init__(self, template, positions, codes: np.ndarray,
                 lens: np.ndarray, params, device, read_chunk: int = None,
                 space: str = "packed", mesh=None):
        if space not in SPACES:
            raise ValueError(f"space must be one of {SPACES}, not {space!r}")
        self.space = space
        self.device = torch.device(device)
        mesh = local_mesh(self.device) if mesh is None else mesh
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {self.device.type} scorer on a "
                             f"{mesh.device_type} mesh")
        self.mesh = mesh
        self.dtype = default_dtype(self.device)
        self.n_max_gaps = params.n_max_gaps
        B, L = codes.shape
        self.n_reads = B
        order = np.arange(B)
        wbuck = np.zeros(B)
        if B > 1:
            # primary key: the pow2 width bucket of the read's widest
            # position; secondary: median compact id of its mapped nodes
            f2c = template.full_to_compact.astype(np.int64)
            keys = np.zeros(B)
            mn0 = positions.map_nodes
            for b in range(B):
                v = mn0[b][mn0[b] >= 0]
                keys[b] = np.median(f2c[v]) if v.size else 0
                w = int((mn0[b] >= 0).sum(axis=1).max(initial=1))
                wbuck[b] = 1 << max(4, (w - 1).bit_length())
            order = np.lexsort((keys, wbuck))
        self.order = order
        codes = np.ascontiguousarray(codes[order])
        lens = np.asarray(lens)[order]
        pos = [np.asarray(a)[order] for a in positions]

        n_cs, n_rs = mesh.shape["cand"], mesh.shape["reads"]
        b_pad = 8 * n_rs
        A0 = pos[0].shape[2]
        A_est = max(16, 1 << max(0, (A0 - 1)).bit_length())
        D_est = template.parent_idx.shape[1]
        per_read = L * A_est * (3 + 3 * D_est) * 4  # bytes of int32 streams
        rc = read_chunk or max(b_pad, int(9e9 // max(per_read, 1)) // b_pad * b_pad)
        rc = -(-rc // b_pad) * b_pad
        # the read blocks, (chunk, reads-axis index r, first sorted read,
        # reads): each chunk, padded to b_pad, split into n_rs equal blocks.
        # A chunk ends every rc reads and where the width bucket changes, so
        # that one wide read does not widen every read's streams
        sb = wbuck[order]
        starts = sorted(set(range(0, B, rc))
                        | set((np.flatnonzero(sb[1:] != sb[:-1]) + 1).tolist()))
        self.blocks = []
        for ci, (c0, c1) in enumerate(zip(starts, starts[1:] + [B])):
            per = -(-(c1 - c0) // b_pad) * b_pad // n_rs
            for r in range(n_rs):
                lo = min(c1, c0 + r * per)
                self.blocks.append((ci, r, lo, min(c1, lo + per) - lo))
        # the blocks this process builds: those with reads that a shard it
        # holds reads
        self.local_blocks = [
            u for u, (_ci, r, _lo, nb) in enumerate(self.blocks)
            if nb and any(mesh.owns(g * n_rs + r) for g in range(n_cs))]
        chunks = []
        for u in self.local_blocks:
            _ci, _r, c0, nb = self.blocks[u]
            c1 = c0 + nb
            # cut the block's slot axis to its own widest used slot, so a
            # block of narrow reads runs at a narrow power-of-two A
            used = (pos[0][c0:c1] >= 0).any(axis=(0, 1))
            w = int(np.flatnonzero(used).max(initial=0)) + 1
            pos_c = type(positions)(*[a[c0:c1, :, :w] for a in pos])
            chunks.append(build_streams(template, pos_c, codes[c0:c1],
                                        lens[c0:c1], b_pad=8))

        # unify the degree across chunks; each chunk keeps its own pow2 width
        d_star = max((s.prevp.shape[1] for s in chunks), default=1)
        for ci, s in enumerate(chunks):
            d_c, a_c = s.prevp.shape[1], s.emis.shape[2]
            a_star = max(16, 1 << (a_c - 1).bit_length())
            if d_c == d_star and a_c == a_star:
                continue
            SENT = s.nc_pad - 1
            pad_d = lambda a, fill: np.concatenate(
                [a, np.full((a.shape[0], d_star - d_c) + a.shape[2:], fill,
                            a.dtype)], axis=1
            ) if d_c < d_star else a
            pad_a = lambda a, fill: np.concatenate(
                [a, np.full(a.shape[:-1] + (a_star - a.shape[-1],), fill,
                            a.dtype)], axis=-1
            ) if a.shape[-1] < a_star else a
            chunks[ci] = s._replace(
                emis=pad_a(s.emis, 9), numce=pad_a(s.numce, SENT),
                selfp=pad_a(s.selfp, -1),
                prevp=pad_a(pad_d(s.prevp, -1), -1),
                curp=pad_a(pad_d(s.curp, -1), -1),
                dence=pad_a(pad_d(s.dence, SENT), SENT),
            )

        # per-chunk NC trim: remap numce/dence to the compact edges the
        # chunk references; every chunk pads to the widest chunk's id count
        useds = []
        for s in chunks:
            SENT = s.nc_pad - 1
            u = np.union1d(np.unique(s.numce), np.unique(s.dence))
            useds.append(u[(u >= 0) & (u != SENT)].astype(np.int64))
        n_used = max((len(u) for u in useds), default=0)
        nc_star = max(128, 1 << int(np.ceil(np.log2(n_used + 2))))
        if chunks and nc_star < chunks[0].nc_pad:
            ce_dt = np.int16 if nc_star <= 32768 else np.int32
            for ci, s in enumerate(chunks):
                u = useds[ci]
                remap = np.full(s.nc_pad, nc_star - 1, dtype=np.int32)
                remap[u] = np.arange(len(u), dtype=np.int32)
                chunks[ci] = s._replace(
                    numce=remap[s.numce].astype(ce_dt),
                    dence=remap[s.dence].astype(ce_dt),
                    nc_pad=nc_star, emittable_len=None,
                    ce_ids=u.astype(np.int32),
                )
        self.chunks = chunks
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        lt = lin_params(params, np_dt)
        # per local block, its streams on each device of the shards that
        # hold it (one upload per distinct device); the constants on every
        # device this process holds
        self._lt = put_replicated(mesh, lt)
        self._dev = []
        for u, s in zip(self.local_blocks, chunks):
            r = self.blocks[u][1]
            devs = {mesh.devices[g, r] for g in range(n_cs)
                    if mesh.owns(g * n_rs + r)}
            self._dev.append({d: self._upload(s, d) for d in devs})

    def block_streams(self, k: int) -> Tuple[torch.Tensor, ...]:
        """The device streams of this process's k-th read block, on the
        first device that holds them (the kernels' stream arguments)."""
        return next(iter(self._dev[k].values()))

    def _upload(self, s: MappedStreams, device) -> Tuple[torch.Tensor, ...]:
        """The chunk's lens and streams as contiguous int32 tensors on
        ``device`` (narrow host arrays travel as they are and widen there)."""
        arrs = (s.lens, s.codes, s.emis, s.numce, s.selfp, s.prevp, s.curp,
                s.dence)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            .to(torch.int32).contiguous() for a in arrs
        )

    def log_sibling(self) -> "MappedScorer":
        """A ``space="log"`` scorer over the same uploaded streams (nothing
        is uploaded again): the rescue of ``score_candidates``."""
        sib = copy.copy(self)
        sib.space = "log"
        return sib

    def per_read(self, candidates: Sequence[Sequence[int]]) -> np.ndarray:
        """[C, B] float64 per-read log-likelihoods, reads in the ORIGINAL
        order: one launch per shard and read block, all launched, then
        gathered (across ranks too)."""
        kernel = {"packed": mapped_scores_log, "log": mapped_scores_log_single,
                  "linear": mapped_scores_linear}[self.space]
        inv_of = lin_inv_total if self.space == "linear" else log_inv_total
        mesh = self.mesh
        n_cs, n_rs = mesh.shape["cand"], mesh.shape["reads"]
        C = len(candidates)
        per = -(-C // n_cs)
        cands = list(candidates) + [candidates[0]] * (per * n_cs - C)
        # one conversion of the lists: every read block reads each group
        cands = np.asarray(cands, dtype=np.float32)
        rows = [max(0, min(C, (g + 1) * per) - g * per) for g in range(n_cs)]
        local = {u: k for k, u in enumerate(self.local_blocks)}
        outs = []
        for u, (_ci, r, _lo, nb) in enumerate(self.blocks):
            for g in range(n_cs):
                i = g * n_rs + r
                if not nb or not rows[g]:
                    outs.append(np.empty((rows[g], nb)))  # nothing to launch
                    continue
                if not mesh.owns(i):
                    outs.append(None)
                    continue
                dev = mesh.devices.flat[i]
                s = self.chunks[local[u]]
                eff, total = _eff_matrix(s, cands[g * per:(g + 1) * per])
                eff_t = torch.as_tensor(eff, dtype=self.dtype, device=dev)
                inv_t = torch.as_tensor(inv_of(total), dtype=self.dtype,
                                        device=dev)
                out = kernel(eff_t, inv_t, *self._dev[local[u]][dev],
                             self._lt[i], n_max_gaps=self.n_max_gaps)
                outs.append(out[:rows[g], :nb])
        blocks = iter(gather_to_host(outs, mesh))
        per_read = np.empty((C, self.n_reads), dtype=np.float64)
        for _ci, _r, lo, nb in self.blocks:
            for g in range(n_cs):
                per_read[g * per:g * per + rows[g], self.order[lo:lo + nb]] = next(blocks)
        return per_read

    def scores_detailed(self, candidates) -> Tuple[np.ndarray, np.ndarray]:
        """(sums [C], ok [C]): total log P(R | X_c) and whether every read
        score is finite."""
        per_read = self.per_read(candidates)
        return per_read.sum(axis=1), np.isfinite(per_read).all(axis=1)

    def scores(self, candidates) -> np.ndarray:
        return self.scores_detailed(candidates)[0]
