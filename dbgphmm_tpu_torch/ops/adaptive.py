"""Sparse-adaptive mapping decode and the hint-constrained refine:
forward over evolving (or given) active sets, backward-by-forward,
score-ratio decode.

PyTorch counterpart of ``dbgphmm_tpu/ops/adaptive.py``.  The JAX versions
are XLA scans, not Pallas kernels; here each ``lax.scan`` is a Python loop
over read positions and ``lax.top_k`` the stable descending sort
``forward._top_k`` (ties keep the lower index first).  The stored forward
tables are ``[L, B, K]``.

* ``mappings_sparse_adaptive`` (ref: freq.rs:60 run_sparse_adaptive): the
  active set of a position is the top ``n_top`` nodes of the previous
  table plus their children (ref: forward.rs:148), so the decode costs
  O(B * L * A) with A = n_top * (D + 1), whatever the graph's size.  The
  first ``n_warmup`` positions run dense and compact to the top-A cells;
  with ``n_warmup = L`` the whole forward is dense and only the stored
  tables are compact (the decode of graphs of 4,000-32,768 full edges).
  ``stored_k`` / ``store_bf16`` trim the stored tables to their top cells
  and store them in bfloat16; the read likelihood comes from the carry.
* ``mappings_refine`` (ref: hint.rs:206-216 run_with_mapping): the same
  backward-by-forward decode over a hint's per-position active sets.

The device scans are CUDA kernels, each with its plain PyTorch version
beside it:

    R1 forward_mapped_tables    the scan at dbgphmm_tpu/ops/adaptive.py:631
       (forward_mapped_tables_reference; csrc/refine.cu)
    R2 decode_from_forward      the scan at dbgphmm_tpu/ops/adaptive.py:533
       (decode_from_forward_reference; csrc/refine.cu)
    A1 adaptive_dense           the dense warm-up scan at
                                dbgphmm_tpu/ops/adaptive.py:349
    A2 adaptive_frontier        the evolving-frontier scan at
                                dbgphmm_tpu/ops/adaptive.py:370
       (A1 and A2: forward_sparse_adaptive, plain version
       forward_sparse_adaptive_reference; csrc/adaptive.cu)

For a model on the CPU a wrapper runs its plain version; on a CUDA device
it checks its inputs and launches its kernels on the current stream, or
raises (``.launches`` counts the launches, ``.calls`` the plain runs).
``mappings_refine`` runs R1 then R2; ``mappings_sparse_adaptive`` runs A1
(and A2 where the warm-up is shorter than the reads) then R2.

The JAX package reads the frontier's children through a one-hot matrix
product (``_onehot_slot_dot``, the TPU's way around slot gathers, with a
finite stand-in for -inf); here they are read with ``torch.gather`` and a
child is kept where its log transition probability is finite.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .forward import (NEG, DeviceModel, _f_init, _f_step, _kahan, _ladd,
                      _ladd3, _lse_deg, _max_shift, _put_last, _ratio_mask,
                      _reverse_codes, _s_log, _scatter_positions, _top_k)
from .sparse import SState, _gather_prev, _gather_self, _s_core, _s_init


def _pack_model(dm: DeviceModel) -> torch.Tensor:
    """All per-node attributes in one [n, 2+5D] table (one gather per step).
    Columns: [init_logp, emission, parent_logt*D, parent_idx*D,
    child_logt*D, child_idx*D, child_emission*D]; ids stored as floats."""
    dt = dm.dtype
    child_emis = dm.emission[dm.child_idx.long()]
    cols = [
        dm.init_logp[:, None], dm.emission[:, None].to(dt), dm.parent_logt,
        dm.parent_idx.to(dt), dm.child_logt, dm.child_idx.to(dt),
        child_emis.to(dt),
    ]
    return torch.cat(cols, dim=1)


def _attr_cols(D: int):
    """Column slices of the packed attribute table."""
    return dict(
        init=0, emis=1,
        plogt=slice(2, 2 + D), pidx=slice(2 + D, 2 + 2 * D),
        clogt=slice(2 + 2 * D, 2 + 3 * D), cidx=slice(2 + 3 * D, 2 + 4 * D),
        cemis=slice(2 + 4 * D, 2 + 5 * D),
    )


def _gather_attrs(pk: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """attrs [B, A, 2+5D] of an active set."""
    return pk[torch.where(nodes >= 0, nodes, 0).long()]


def _s_step_attrs(dm: DeviceModel, st: SState, cur_nodes: torch.Tensor,
                  attrs: torch.Tensor, x: torch.Tensor,
                  valid: torch.Tensor) -> SState:
    """One mapping-constrained forward step (ref: forward.rs:276-306) with
    the per-node attributes from one packed gather (renormalised)."""
    c = _attr_cols(dm.parent_idx.shape[1])
    slot_ok = cur_nodes >= 0
    par_idx = attrs[..., c["pidx"]].to(torch.int32)
    par_logt = torch.where(slot_ok[:, :, None], attrs[..., c["plogt"]], NEG)
    init_lp = torch.where(slot_ok, attrs[..., c["init"]], NEG)
    emis = attrs[..., c["emis"]].to(torch.int32)
    p_emit = torch.where(emis == x[:, None], dm.lt.match, dm.lt.mismatch)
    return _s_core(
        dm, st, cur_nodes, par_logt, init_lp, p_emit,
        prev=lambda v: _gather_prev(par_idx, st.nodes, v),
        self_=lambda v: _gather_self(cur_nodes, st.nodes, v),
        cur=lambda v: _gather_prev(par_idx, cur_nodes, v),
        valid=valid, renorm=True)


class AdaptiveTables(NamedTuple):
    nodes: torch.Tensor  # [L, B, K]
    m: torch.Tensor  # [L, B, K] (possibly a reduced storage dtype)
    i: torch.Tensor
    d: torch.Tensor
    off: torch.Tensor  # [L, B]
    e: torch.Tensor  # [B] final score (offset applied)


# -- the evolving active set --------------------------------------------------


def _dedup_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """Mark duplicate node ids (per row) as -1, keeping every surviving id
    in its slot: slot order is priority order (callers cut the row to its
    leading A slots).  A stable sort finds the duplicates, so the earliest
    slot keeps an id; then the sorted row is scattered back."""
    s, order = torch.sort(nodes, dim=-1, stable=True)
    dup = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool),
                     s[:, 1:] == s[:, :-1]], dim=1)
    s = torch.where(dup | (s < 0), -1, s)
    return torch.empty_like(s).scatter_(1, order, s)


def _frontier(st: SState, n_top: int, max_ratio):
    """(top_vals, top_slots) of the merged m+i+d table of the carried active
    set, score-ratio selected under the top-``n_top`` cap (ref:
    forward.rs:112-115)."""
    merged = torch.where(st.nodes >= 0, _ladd3(st.m, st.i, st.d), NEG)
    if max_ratio is not None:
        mx = merged.amax(dim=-1, keepdim=True)
        merged = torch.where(merged >= mx - max_ratio, merged, NEG)
    return _top_k(merged, min(n_top, merged.shape[1]))


def _with_children(top_nodes, childs, child_logt):
    """[top nodes, their children where the transition exists], deduped."""
    child_ok = (top_nodes[:, :, None] >= 0) & torch.isfinite(child_logt)
    childs = torch.where(child_ok, childs, -1)
    cand = torch.cat([top_nodes, childs.reshape(childs.shape[0], -1)], dim=1)
    return _dedup_nodes(cand)


def _next_active(dm: DeviceModel, st: SState, n_top: int,
                 max_ratio=None) -> torch.Tensor:
    """Top-``n_top`` of the previous table -> themselves and their children
    (ref: forward.rs:148 to_childs_and_us), children from the model."""
    top_vals, top_slots = _frontier(st, n_top, max_ratio)
    top_nodes = torch.gather(st.nodes, 1, top_slots)
    top_nodes = torch.where(torch.isfinite(top_vals), top_nodes, -1)
    safe = torch.where(top_nodes >= 0, top_nodes, 0).long()
    return _with_children(top_nodes, dm.child_idx[safe], dm.child_logt[safe])


def _next_active_attrs(dm: DeviceModel, st: SState, attrs: torch.Tensor,
                       n_top: int, max_ratio=None) -> torch.Tensor:
    """``_next_active`` reading the top nodes' children from the carried
    attribute block [B, A, 2+5D] (slot gathers) instead of the model."""
    D = dm.parent_idx.shape[1]
    c = _attr_cols(D)
    top_vals, top_slots = _frontier(st, n_top, max_ratio)
    top_nodes = torch.gather(st.nodes, 1, top_slots)
    top_nodes = torch.where(torch.isfinite(top_vals), top_nodes, -1)
    slot_d = top_slots[:, :, None].expand(-1, -1, D)
    child_logt = torch.gather(attrs[..., c["clogt"]], 1, slot_d)
    childs = torch.gather(attrs[..., c["cidx"]], 1, slot_d).to(torch.int32)
    return _with_children(top_nodes, childs, child_logt)


def _initial_active(dm: DeviceModel, batch: int, n_top: int) -> torch.Tensor:
    """Nodes with the highest init prob, for every read: [batch, K] int32
    with K = min(n_top * (D + 1), n) (the Begin state reaches any node,
    weighted by init_logp)."""
    k = min(n_top * (dm.child_idx.shape[1] + 1), dm.init_logp.shape[0])
    vals, ids = _top_k(dm.init_logp, k)
    ids = torch.where(torch.isfinite(vals), ids, -1).to(torch.int32)
    return ids[None].expand(batch, -1).contiguous()


def _dense_to_sparse(fstate, A: int) -> SState:
    """Compact a dense FState [B, n] into its top-A active-set SState."""
    merged = _ladd3(fstate.m, fstate.i, fstate.d)
    B, n = merged.shape
    top_vals, top_ids = _top_k(merged, min(A, n))
    nodes = torch.where(torch.isfinite(top_vals), top_ids, -1).to(torch.int32)

    def take(tab):
        out = torch.where(nodes >= 0, torch.gather(tab, 1, top_ids), NEG)
        if out.shape[1] < A:
            out = torch.cat([out, out.new_full((B, A - out.shape[1]), NEG)], 1)
        return out

    if nodes.shape[1] < A:
        nodes = torch.cat([nodes, nodes.new_full((B, A - nodes.shape[1]), -1)], 1)
    return SState(nodes=nodes, m=take(fstate.m), i=take(fstate.i),
                  d=take(fstate.d), mb=fstate.mb, ib=fstate.ib, e=fstate.e,
                  off=fstate.off, off_c=fstate.off_c)


@torch.no_grad()
def forward_sparse_adaptive_reference(
        dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
        n_top: int = 40, n_warmup: int = 16, max_ratio: float = None,
        stored_k: Optional[int] = None,
        store_bf16: bool = False) -> AdaptiveTables:
    """Plain PyTorch version of A1 and A2: the sparse-adaptive forward
    storing per-step active tables.

    The first ``n_warmup`` positions run dense (exact) and store the table
    compacted to its top A = min(n_top * (D + 1), n) cells (ref:
    forward.rs:119-138); then the active set evolves (``_next_active_attrs``
    over the carried attribute block, one packed gather per step).  The
    carry always keeps all A cells; the stored tables keep the top
    ``stored_k`` cells by max(m, i, d) and, with ``store_bf16``, in
    bfloat16 (they only select the decode's cells; the read
    log-likelihood ``e`` comes from the carry)."""
    forward_sparse_adaptive_reference.calls += 1
    B, L = codes.shape
    n = dm.init_logp.shape[0]
    A = min(n_top * (dm.child_idx.shape[1] + 1), n)
    W = min(n_warmup, L)
    K = A if stored_k is None else min(stored_k, A)
    dt, dev = dm.dtype, dm.device
    sdt = torch.bfloat16 if store_bf16 else dt
    ns = torch.empty((L, B, K), dtype=torch.int32, device=dev)
    ms = torch.empty((L, B, K), dtype=sdt, device=dev)
    is_, ds = torch.empty_like(ms), torch.empty_like(ms)
    offs = torch.empty((L, B), dtype=dt, device=dev)

    def emit(p, st):
        nodes, m, i, d = st.nodes, st.m, st.i, st.d
        if K < nodes.shape[1]:
            key = torch.where(nodes >= 0,
                              torch.maximum(torch.maximum(m, i), d), NEG)
            _, slots = _top_k(key, K)
            nodes, m, i, d = (torch.gather(a, 1, slots) for a in (nodes, m, i, d))
        ns[p], ms[p], is_[p], ds[p], offs[p] = nodes, m, i, d, st.off

    codes_t = codes.t()
    # phase 1: dense warmup, storing compacted top-A tables
    fst = _f_init((B,), n, dt, dev)
    pidx = dm.parent_idx.long()
    for p in range(W):
        fst = _f_step(dm, fst, codes_t[p], p < lens, True, pidx)
        emit(p, _dense_to_sparse(fst, A))
    st = _dense_to_sparse(fst, A)

    # phase 2: the evolving frontier
    pk = _pack_model(dm)
    attrs = _gather_attrs(pk, st.nodes)
    for p in range(W, L):
        valid = p < lens
        cur = _next_active_attrs(dm, st, attrs, n_top, max_ratio)[:, :A]
        attrs1 = _gather_attrs(pk, cur)
        st = _s_step_attrs(dm, st, cur, attrs1, codes_t[p], valid)
        attrs = torch.where(valid[:, None, None], attrs1, attrs)
        emit(p, st)
    return AdaptiveTables(nodes=ns, m=ms, i=is_, d=ds, off=offs, e=st.e + st.off)


forward_sparse_adaptive_reference.calls = 0


def forward_mapped_tables_reference(dm: DeviceModel, codes: torch.Tensor,
                                    lens: torch.Tensor, map_nodes: torch.Tensor
                                    ) -> AdaptiveTables:
    """Plain PyTorch version of R1: the mapping-constrained forward storing
    per-step active tables (ref: forward.rs:51-77 forward_with_mapping).
    codes [B, L] int, lens [B] int, map_nodes [B, L, A] int (-1 pad), all
    on dm's device."""
    forward_mapped_tables_reference.calls += 1
    B, L = codes.shape
    A = map_nodes.shape[2]
    dt, dev = dm.dtype, dm.device
    st = _s_init(dm, B, A)
    ns = torch.empty((L, B, A), dtype=torch.int32, device=dev)
    ms = torch.empty((L, B, A), dtype=dt, device=dev)
    is_, ds = torch.empty_like(ms), torch.empty_like(ms)
    offs = torch.empty((L, B), dtype=dt, device=dev)
    pk = _pack_model(dm)
    codes_t = codes.t()
    nodes_t = map_nodes.transpose(0, 1)
    for p in range(L):
        nodes_p = nodes_t[p]
        st = _s_step_attrs(dm, st, nodes_p, _gather_attrs(pk, nodes_p),
                           codes_t[p], p < lens)
        ns[p], ms[p], is_[p], ds[p], offs[p] = st.nodes, st.m, st.i, st.d, st.off
    return AdaptiveTables(nodes=ns, m=ms, i=is_, d=ds, off=offs, e=st.e + st.off)


forward_mapped_tables_reference.calls = 0


# -- backward by forward and the decode ---------------------------------------


class BCarry(NamedTuple):
    nodes: torch.Tensor  # [B, A]
    m: torch.Tensor
    i: torch.Tensor
    d: torch.Tensor
    ib: torch.Tensor  # [B]
    off: torch.Tensor
    off_c: torch.Tensor


def _b_step_sparse(dm: DeviceModel, st: BCarry, cur_nodes: torch.Tensor,
                   attrs: torch.Tensor, x: torch.Tensor,
                   valid: torch.Tensor) -> BCarry:
    """Backward step restricted to the forward's active cells
    (ref: backward.rs:216-261)."""
    lt = dm.lt
    c = _attr_cols(dm.parent_idx.shape[1])
    slot_ok = cur_nodes >= 0
    child_idx = attrs[..., c["cidx"]].to(torch.int32)
    child_logt = torch.where(slot_ok[:, :, None], attrs[..., c["clogt"]], NEG)
    emis_child = attrs[..., c["cemis"]].to(torch.int32)
    p_emit_child = torch.where(emis_child == x[:, None, None], lt.match,
                               lt.mismatch)

    bm_next = _gather_prev(child_idx, st.nodes, st.m)
    bi_self = _gather_self(cur_nodes, st.nodes, st.i)

    bd0 = _lse_deg(child_logt + lt.DM + p_emit_child + bm_next)
    bd0 = _ladd(bd0, lt.DI + lt.random + bi_self)
    d_new = bd0
    bdt = bd0
    for _ in range(dm.n_max_gaps):
        bdt = _lse_deg(child_logt + lt.DD + _gather_prev(child_idx, cur_nodes, bdt))
        d_new = _ladd(d_new, bdt)

    bd_child = _gather_prev(child_idx, cur_nodes, d_new)

    m_new = _lse_deg(
        child_logt + _ladd(lt.MM + p_emit_child + bm_next, lt.MD + bd_child))
    m_new = _ladd(m_new, lt.MI + lt.random + bi_self)
    i_new = _lse_deg(
        child_logt + _ladd(lt.IM + p_emit_child + bm_next, lt.ID + bd_child))
    i_new = _ladd(i_new, lt.II + lt.random + bi_self)

    ib_new = torch.full_like(st.ib, NEG)  # not tracked sparsely (unused)

    m_new = torch.where(slot_ok, m_new, NEG)
    i_new = torch.where(slot_ok, i_new, NEG)
    d_new = torch.where(slot_ok, d_new, NEG)

    shift = _max_shift(m_new, valid)
    m_new, i_new, d_new = (m_new - shift[:, None], i_new - shift[:, None],
                           d_new - shift[:, None])
    off, off_c = _kahan(st.off, st.off_c, shift)

    v1 = valid[:, None]
    return BCarry(
        nodes=torch.where(v1, cur_nodes, st.nodes),
        m=torch.where(v1, m_new, st.m),
        i=torch.where(v1, i_new, st.i),
        d=torch.where(v1, d_new, st.d),
        ib=torch.where(valid, ib_new, st.ib),
        off=torch.where(valid, off, st.off),
        off_c=torch.where(valid, off_c, st.off_c),
    )


def decode_from_forward_reference(dm: DeviceModel, codes: torch.Tensor,
                                  lens: torch.Tensor, f: AdaptiveTables,
                                  n_active: int, max_ratio):
    """Plain PyTorch version of R2 with the decode's ends: the
    backward-by-forward + per-position top-k decode over the stored forward
    tables (ref: backward.rs:101-142, table.rs:500-517); the stored tables
    may be bfloat16, the backward carry is ``dm.dtype`` (a sum of the two
    is in the wider type).

    Returns (logp [B], map_nodes [B, L, k], map_logp [B, L, k])."""
    decode_from_forward_reference.calls += 1
    B, L = codes.shape
    dt, dev = dm.dtype, dm.device
    logp = f.e
    ar = torch.arange(B, device=dev)
    lens_l = lens.long()

    last = (lens_l - 1).clamp(0, L - 1)
    final_nodes = f.nodes[last, ar]
    pe = torch.where(final_nodes >= 0, dm.lt.end, NEG).to(dt)
    z = torch.zeros(B, dtype=dt, device=dev)
    bst = BCarry(nodes=final_nodes, m=pe, i=pe, d=pe,
                 ib=torch.full((B,), NEG, dtype=dt, device=dev), off=z, off_c=z)

    k = min(n_active, f.nodes.shape[2])
    tops_logp = torch.empty((L, B, k), dtype=dt, device=dev)
    tops_nodes = torch.empty((L, B, k), dtype=torch.int32, device=dev)
    pk = _pack_model(dm)
    xs_rev_t = _reverse_codes(codes, lens).t()
    for t in range(L):
        valid = t < lens
        i_merge = lens_l - 1 - t  # merged index of the B table produced
        i_f = (i_merge - 1).clamp(0, L - 1)
        cur_nodes = f.nodes[i_f, ar]
        bst = _b_step_sparse(dm, bst, cur_nodes, _gather_attrs(pk, cur_nodes),
                             xs_rev_t[t], valid)
        # S[i] = F[i] * B[i] / P on these cells
        fm, fi, fd = f.m[i_f, ar], f.i[i_f, ar], f.d[i_f, ar]
        foff = f.off[i_f, ar]
        scale = torch.where(i_merge <= 0, NEG, foff + bst.off - logp)[:, None]
        s_lin = (torch.exp(fm + bst.m + scale) + torch.exp(fi + bst.i + scale)
                 + torch.exp(fd + bst.d + scale))
        top_logp, top_slot = _top_k(_s_log(s_lin), k)
        top_nodes = torch.gather(cur_nodes, 1, top_slot)
        top_nodes = torch.where(torch.isfinite(top_logp), top_nodes, -1)
        tops_logp[t], tops_nodes[t] = _ratio_mask(top_logp, top_nodes, max_ratio)
    return _decode_finish(dm, lens, f, tops_logp, tops_nodes, max_ratio)


decode_from_forward_reference.calls = 0


def _decode_finish(dm: DeviceModel, lens: torch.Tensor, f: AdaptiveTables,
                   tops_logp: torch.Tensor, tops_nodes: torch.Tensor,
                   max_ratio):
    """The decode's ends, after the scan's per-step top k (scan order,
    [L, B, k]): the rows into read-position order, and read position
    len - 1 from the forward's last cells.  Returns (logp [B], map_nodes
    [B, L, k], map_logp [B, L, k])."""
    L, B, k = tops_logp.shape
    dev = dm.device
    logp = f.e
    ar = torch.arange(B, device=dev)
    lens_l = lens.long()
    steps = torch.arange(L, device=dev)[:, None]
    i_merges = lens_l[None, :] - 1 - steps  # [L, B], as the scan steps them
    valids = steps < lens[None, :]
    map_logp, map_nodes = _scatter_positions(tops_logp, tops_nodes, i_merges,
                                             valids, L)
    # read position len-1: S[len] = F[len] * B_init(p_end)
    last = (lens_l - 1).clamp(0, L - 1)
    final_nodes = f.nodes[last, ar]
    fm_l, fi_l, fd_l = f.m[last, ar], f.i[last, ar], f.d[last, ar]
    scale_l = (f.off[last, ar] + dm.lt.end - logp)[:, None]
    s_last = (torch.exp(fm_l + scale_l) + torch.exp(fi_l + scale_l)
              + torch.exp(fd_l + scale_l))
    s_last = torch.where(final_nodes >= 0, s_last, torch.zeros_like(s_last))
    last_logp, last_slot = _top_k(_s_log(s_last), k)
    last_nodes = torch.gather(final_nodes, 1, last_slot)
    last_nodes = torch.where(torch.isfinite(last_logp), last_nodes, -1)
    last_logp, last_nodes = _ratio_mask(last_logp, last_nodes, max_ratio)
    map_nodes, map_logp = _put_last(map_logp, map_nodes, last_logp, last_nodes,
                                    lens, L)
    return logp, map_nodes, map_logp


# -- the kernels R1 and R2 ----------------------------------------------------

REFINE_MAX_WIDTH = 256  # R1: hint slots, one per thread of a block
DECODE_MAX_CELLS = 512  # R2: stored cells, two per thread above 256
ADAPTIVE_MAX_CELLS = 512  # A1 / A2: carried cells A (A2: one per thread)
REFINE_MAX_DEGREE = 5  # parent / child columns (the padded model's degree)
REFINE_MAX_GAPS = 32  # deletion-closure rounds (n_max_gaps)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check(where: str, dm: DeviceModel, tensors: dict, width: int,
           max_width: int) -> None:
    """Refuse what the kernel does not take, before anything is built or
    launched: ``tensors`` maps a name to (tensor, allowed dtypes, shape);
    the model's arrays are checked too.  Then the device: every tensor on
    dm's device, which must be a CUDA device."""
    dt = dm.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"{where}: the model is {dt}, not float32 or float64")
    n, D = dm.parent_idx.shape
    model = dict(emission=(dm.emission, (torch.int32,), (n,)),
                 init_logp=(dm.init_logp, (dt,), (n,)),
                 parent_idx=(dm.parent_idx, (torch.int32,), (n, D)),
                 parent_logt=(dm.parent_logt, (dt,), (n, D)),
                 child_idx=(dm.child_idx, (torch.int32,), (n, D)),
                 child_logt=(dm.child_logt, (dt,), (n, D)))
    named = {**model, **tensors}
    for name, (t, dtypes, shape) in named.items():
        if t.dtype not in dtypes:
            raise ValueError(f"{where}: {name} is {t.dtype}, not "
                             f"{' or '.join(str(x) for x in dtypes)}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{where}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
    if not 1 <= width <= max_width:
        raise ValueError(f"{where}: width {width} outside 1..{max_width}")
    if not 1 <= D <= REFINE_MAX_DEGREE:
        raise ValueError(f"{where}: degree D={D} outside 1..{REFINE_MAX_DEGREE}")
    if not 0 <= dm.n_max_gaps <= REFINE_MAX_GAPS:
        raise ValueError(f"{where}: n_max_gaps={dm.n_max_gaps} outside "
                         f"0..{REFINE_MAX_GAPS}")
    if dm.device.type != "cuda":
        raise ValueError(f"{where} runs on cpu or cuda, not {dm.device}")
    for name, (t, _d, _s) in named.items():
        if t.device != dm.device:
            raise ValueError(f"{where}: {name} is on {t.device}, the model on "
                             f"{dm.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(wrapper, lib: ctypes.CDLL, entry: str, device: torch.device,
            args: list) -> None:
    """One launch of ``entry`` of ``lib`` on the current stream of
    ``device``, counted on ``wrapper``; raises with the CUDA error string if
    it is refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.dbg_cuda_error_string(rc).decode()}")
    wrapper.launches += 1


def forward_mapped_tables(dm: DeviceModel, codes: torch.Tensor,
                          lens: torch.Tensor, map_nodes: torch.Tensor
                          ) -> AdaptiveTables:
    """R1: the mapping-constrained forward storing per-step active tables
    (ref: forward.rs:51-77 forward_with_mapping): nodes, m, i, d [L, B, A],
    off [L, B], e [B] (the read log-likelihood, offset applied).

    A model on the CPU runs :func:`forward_mapped_tables_reference`.  On a
    CUDA device the model is float32 or float64 (its degree at most
    REFINE_MAX_DEGREE, n_max_gaps at most REFINE_MAX_GAPS), codes [B, L],
    lens [B] and map_nodes [B, L, A] (-1 pad, A <= REFINE_MAX_WIDTH) are
    contiguous int32 on its device, and ``dbg_refine_forward`` of
    ``csrc/refine.cu`` runs on the current stream."""
    if dm.device.type == "cpu":
        return forward_mapped_tables_reference(dm, codes, lens, map_nodes)
    i32 = (torch.int32,)
    B, L = codes.shape if codes.dim() == 2 else (-1, -1)
    A = map_nodes.shape[-1] if map_nodes.dim() == 3 else -1
    _check("forward_mapped_tables", dm,
           dict(codes=(codes, i32, (B, L)), lens=(lens, i32, (B,)),
                map_nodes=(map_nodes, i32, (B, L, A))), A, REFINE_MAX_WIDTH)
    dt, dev = dm.dtype, dm.device
    tab = lambda: torch.empty((L, B, A), dtype=dt, device=dev)
    out = AdaptiveTables(
        nodes=torch.empty((L, B, A), dtype=torch.int32, device=dev),
        m=tab(), i=tab(), d=tab(),
        off=torch.empty((L, B), dtype=dt, device=dev),
        e=torch.empty((B,), dtype=dt, device=dev))
    if B:
        lt = torch.stack(list(dm.lt))
        _launch(forward_mapped_tables, _build.refine_lib(),
                "dbg_refine_forward", dev,
                [_DTYPE_CODE[dt]]
                + [_ptr(t) for t in (dm.emission, dm.init_logp, dm.parent_idx,
                                     dm.parent_logt, lt, codes, lens,
                                     map_nodes, *out)]
                + [B, L, A, int(dm.parent_idx.shape[1]), dm.n_max_gaps])
    return out


forward_mapped_tables.launches = 0


def decode_from_forward(dm: DeviceModel, codes: torch.Tensor,
                        lens: torch.Tensor, f: AdaptiveTables, n_active: int,
                        max_ratio):
    """R2 with the decode's ends: the backward-by-forward + per-position
    top-k decode over the stored forward tables (ref: backward.rs:101-142,
    table.rs:500-517), k = min(n_active, K) for K stored cells.

    A model on the CPU runs :func:`decode_from_forward_reference`.  On a
    CUDA device the model is float32 or float64 (degree and n_max_gaps as
    in :func:`forward_mapped_tables`); the tables' nodes [L, B, K] int32
    (K <= DECODE_MAX_CELLS), m / i / d [L, B, K] in the model's dtype or
    bfloat16, off [L, B] and e [B] in the model's dtype, codes and lens
    int32, all contiguous on its device; ``dbg_refine_decode`` of
    ``csrc/refine.cu`` runs the scan on the current stream and
    :func:`_decode_finish` the rest.  Returns (logp [B], map_nodes
    [B, L, k], map_logp [B, L, k])."""
    if dm.device.type == "cpu":
        return decode_from_forward_reference(dm, codes, lens, f, n_active,
                                             max_ratio)
    i32, dt = (torch.int32,), dm.dtype
    L, B, K = f.nodes.shape if f.nodes.dim() == 3 else (-1, -1, -1)
    _check("decode_from_forward", dm,
           dict(codes=(codes, i32, (B, L)), lens=(lens, i32, (B,)),
                nodes=(f.nodes, i32, (L, B, K)),
                m=(f.m, (dt, torch.bfloat16), (L, B, K)),
                i=(f.i, (f.m.dtype,), (L, B, K)),
                d=(f.d, (f.m.dtype,), (L, B, K)),
                off=(f.off, (dt,), (L, B)), e=(f.e, (dt,), (B,))),
           K, DECODE_MAX_CELLS)
    if n_active < 1:
        raise ValueError(f"decode_from_forward: n_active={n_active} < 1")
    tops_logp, tops_nodes = decode_tops(dm, codes, lens, f, min(n_active, K),
                                        max_ratio)
    return _decode_finish(dm, lens, f, tops_logp, tops_nodes, max_ratio)


decode_from_forward.launches = 0


def decode_tops(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                f: AdaptiveTables, k: int, max_ratio):
    """R2's launch alone, on inputs :func:`decode_from_forward` has checked:
    the scan's per-step top ``k`` (tops_logp, tops_nodes), [L, B, k] in
    scan order (counted on ``decode_from_forward.launches``)."""
    L, B, K = f.nodes.shape
    dev = dm.device
    tops_logp = torch.empty((L, B, k), dtype=dm.dtype, device=dev)
    tops_nodes = torch.empty((L, B, k), dtype=torch.int32, device=dev)
    if B:
        lt = torch.stack(list(dm.lt))
        ratio = 0.0 if max_ratio is None else float(max_ratio)
        _launch(decode_from_forward, _build.refine_lib(),
                "dbg_refine_decode", dev,
                [_DTYPE_CODE[dm.dtype], _DTYPE_CODE[f.m.dtype]]
                + [_ptr(t) for t in (dm.emission, dm.child_idx, dm.child_logt,
                                     lt, codes, lens, *f, tops_logp,
                                     tops_nodes)]
                + [B, L, K, k, int(dm.parent_idx.shape[1]), dm.n_max_gaps,
                   int(max_ratio is not None), ctypes.c_double(ratio)])
    return tops_logp, tops_nodes


def forward_sparse_adaptive(dm: DeviceModel, codes: torch.Tensor,
                            lens: torch.Tensor, n_top: int = 40,
                            n_warmup: int = 16, max_ratio: float = None,
                            stored_k: Optional[int] = None,
                            store_bf16: bool = False) -> AdaptiveTables:
    """A1 then A2: the sparse-adaptive forward storing per-step active
    tables (see :func:`forward_sparse_adaptive_reference`): nodes, m, i, d
    [L, B, K] (K = min(stored_k, A) cells of A = min(n_top * (D + 1), n);
    m / i / d in bfloat16 with ``store_bf16``), off [L, B], e [B] (the read
    log-likelihood, offset applied).

    A model on the CPU runs :func:`forward_sparse_adaptive_reference`.  On
    a CUDA device the model is float32 or float64 (its degree at most
    REFINE_MAX_DEGREE, n_max_gaps at most REFINE_MAX_GAPS), A is at most
    ADAPTIVE_MAX_CELLS, codes [B, L] and lens [B] are contiguous int32 on
    its device; :func:`adaptive_dense` (A1) runs positions [0, W) of
    W = min(n_warmup, L) and, where W < L, :func:`adaptive_frontier` (A2)
    the rest, on the current stream."""
    if dm.device.type == "cpu":
        return forward_sparse_adaptive_reference(
            dm, codes, lens, n_top=n_top, n_warmup=n_warmup,
            max_ratio=max_ratio, stored_k=stored_k, store_bf16=store_bf16)
    if n_top < 1 or n_warmup < 0 or (stored_k is not None and stored_k < 1):
        raise ValueError(f"forward_sparse_adaptive: n_top={n_top}, n_warmup="
                         f"{n_warmup}, stored_k={stored_k}")
    i32 = (torch.int32,)
    B, L = codes.shape if codes.dim() == 2 else (-1, -1)
    n, D = dm.parent_idx.shape
    A = min(n_top * (D + 1), n)
    _check("forward_sparse_adaptive", dm,
           dict(codes=(codes, i32, (B, L)), lens=(lens, i32, (B,))), A,
           ADAPTIVE_MAX_CELLS)
    K = A if stored_k is None else min(stored_k, A)
    W = min(n_warmup, L)
    dt, dev = dm.dtype, dm.device
    sdt = torch.bfloat16 if store_bf16 else dt
    tab = lambda: torch.empty((L, B, K), dtype=sdt, device=dev)
    out = AdaptiveTables(
        nodes=torch.empty((L, B, K), dtype=torch.int32, device=dev),
        m=tab(), i=tab(), d=tab(),
        off=torch.empty((L, B), dtype=dt, device=dev),
        e=torch.empty((B,), dtype=dt, device=dev))
    if B:
        carry = (torch.empty((B, A), dtype=torch.int32, device=dev),
                 *(torch.empty((B, A), dtype=dt, device=dev) for _ in range(3)),
                 torch.empty((B, 5), dtype=dt, device=dev))
        lt = torch.stack(list(dm.lt))
        adaptive_dense(dm, lt, codes, lens, out, carry, A, K, W)
        if W < L:
            adaptive_frontier(dm, lt, codes, lens, out, carry, A, K, W, n_top,
                              max_ratio)
    return out


forward_sparse_adaptive.launches = 0


def adaptive_dense(dm: DeviceModel, lt: torch.Tensor, codes: torch.Tensor,
                   lens: torch.Tensor, out: AdaptiveTables, carry: tuple,
                   A: int, K: int, W: int) -> None:
    """A1's launch alone, on inputs :func:`forward_sparse_adaptive` has
    checked: rows [0, W) of ``out``, its e, and the compacted carry
    (nodes, m, i, d [B, A], [B, 5] scalars) for A2.  Its scratch holds the
    dense state, 7 n elements of the model's type per read (csrc/adaptive.cu:
    A1_ARRAYS)."""
    L, B, _K = out.nodes.shape
    n = int(dm.init_logp.shape[0])
    scratch = torch.empty((B, 7, n), dtype=dm.dtype, device=dm.device)
    _launch(adaptive_dense, _build.adaptive_lib(), "dbg_adaptive_dense",
            dm.device,
            [_DTYPE_CODE[dm.dtype], _DTYPE_CODE[out.m.dtype]]
            + [_ptr(t) for t in (dm.emission, dm.init_logp, dm.parent_idx,
                                 dm.parent_logt, lt, codes, lens, scratch,
                                 *out, *carry)]
            + [B, L, n, A, K, W, int(dm.parent_idx.shape[1]), dm.n_max_gaps])
    forward_sparse_adaptive.launches += 1


adaptive_dense.launches = 0


def adaptive_frontier(dm: DeviceModel, lt: torch.Tensor, codes: torch.Tensor,
                      lens: torch.Tensor, out: AdaptiveTables, carry: tuple,
                      A: int, K: int, W: int, n_top: int, max_ratio) -> None:
    """A2's launch alone, after :func:`adaptive_dense`: rows [W, L) of
    ``out`` and its e, from A1's carry."""
    L, B, _K = out.nodes.shape
    ratio = 0.0 if max_ratio is None else float(max_ratio)
    _launch(adaptive_frontier, _build.adaptive_lib(),
            "dbg_adaptive_frontier", dm.device,
            [_DTYPE_CODE[dm.dtype], _DTYPE_CODE[out.m.dtype]]
            + [_ptr(t) for t in (dm.emission, dm.init_logp, dm.parent_idx,
                                 dm.parent_logt, dm.child_idx, dm.child_logt,
                                 lt, codes, lens, *carry, *out)]
            + [B, L, A, K, W, int(dm.parent_idx.shape[1]), dm.n_max_gaps,
               n_top, int(max_ratio is not None), ctypes.c_double(ratio)])
    forward_sparse_adaptive.launches += 1


adaptive_frontier.launches = 0


def mappings_sparse_adaptive(dm: DeviceModel, codes: torch.Tensor,
                             lens: torch.Tensor, n_top: int = 40,
                             n_active: int = 40, max_ratio: float = None,
                             n_warmup: int = 16, stored_k: Optional[int] = None,
                             store_bf16: bool = False):
    """Sparse-adaptive forward + backward-by-forward decode (ref: freq.rs:60
    run_sparse_adaptive + hint.rs:124-142); the forward is A1 / A2, the
    decode R2.

    Returns (logp [B], map_nodes [B, L, k], map_logp [B, L, k]) on dm's
    device, k = min(n_active, stored cells)."""
    with torch.no_grad():
        f = forward_sparse_adaptive(dm, codes, lens, n_top=n_top,
                                    n_warmup=n_warmup, max_ratio=max_ratio,
                                    stored_k=stored_k, store_bf16=store_bf16)
        return decode_from_forward(dm, codes, lens, f, n_active, max_ratio)


def mappings_refine(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                    hint_nodes: torch.Tensor, n_active: int = 40,
                    max_ratio: float = None):
    """Hint-seeded mapping regeneration: forward/backward restricted to the
    hint's per-base active sets (R1, then R2), then score-ratio
    re-selection (ref: hint.rs:206-216 run_with_mapping).

    Returns (logp [B], map_nodes [B, L, n_active'], map_logp), on dm's
    device; ``logp`` is the mapping-constrained read log-likelihood."""
    with torch.no_grad():
        f = forward_mapped_tables(dm, codes, lens, hint_nodes)
        return decode_from_forward(dm, codes, lens, f, n_active, max_ratio)
