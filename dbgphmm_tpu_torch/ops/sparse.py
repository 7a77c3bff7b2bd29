"""Mapping-constrained forward: slot positions, mapping padding, the
active-set gathers and the mapped forward score.

PyTorch counterpart of ``dbgphmm_tpu/ops/sparse.py``: :class:`SState`,
``_s_step`` and ``forward_scores_mapped`` (ref: forward.rs:79-89
forward_with_mapping_score_only; the recursion of ``_s_step`` is shared
with the refine's ``ops.adaptive._s_step_attrs`` through ``_s_core``),
:class:`MappedPositions` and ``precompute_positions`` (computed natively
by ``csrc/host/positions.cpp``), and ``pad_mappings``.

Per read position the table is restricted to the position's active set
(the mapping).  "Which slot of the previous set holds my parent" is an
equality match of node ids (``_gather_prev`` / ``_gather_self``); the
slot positions that :class:`MappedPositions` precomputes feed the scorer
kernels of ``ops.mapped_scorer``.  Like the dense recursions, the step
broadcasts a candidate-stacked model (``init_logp`` [C, 1, n], ``parent_logt`` [C, 1, n, D]) against
states [C, B, A].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .forward import (NEG, DeviceModel, _batch_shape, _kahan, _ladd, _ladd3,
                      _lse_deg, _max_shift)


def _gather_prev(parent_idx: torch.Tensor, prev_nodes: torch.Tensor,
                 prev_vals: torch.Tensor) -> torch.Tensor:
    """For each (b, a, d): prev_vals at the slot of prev_nodes that holds
    node parent_idx[b, a, d], or -inf if absent.

    parent_idx [B, A, D] int; prev_nodes [B, A'] int (-1 pad);
    prev_vals [*, B, A'] -> [*, B, A, D]."""
    match = parent_idx[:, :, :, None] == prev_nodes[:, None, None, :]
    vals = torch.where(match, prev_vals[..., None, None, :],
                       torch.full((), NEG, dtype=prev_vals.dtype,
                                  device=prev_vals.device))
    return vals.amax(dim=-1)


def _gather_self(cur_nodes: torch.Tensor, prev_nodes: torch.Tensor,
                 prev_vals: torch.Tensor) -> torch.Tensor:
    """prev_vals at each current node's slot in the previous set (or -inf):
    [*, B, A]."""
    match = cur_nodes[:, :, None] == prev_nodes[:, None, :]
    vals = torch.where(match, prev_vals[..., None, :],
                       torch.full((), NEG, dtype=prev_vals.dtype,
                                  device=prev_vals.device))
    return vals.amax(dim=-1)


def _per_slot(arr: torch.Tensor, nodes: torch.Tensor, n_trail: int) -> torch.Tensor:
    """arr [n, *trail] at nodes [B, A] -> [B, A, *trail]; a candidate-stacked
    arr [C, 1, n, *trail] gives [C, B, A, *trail]."""
    if arr.dim() == 1 + n_trail:
        return arr[nodes]
    return arr.flatten(0, arr.dim() - 2 - n_trail)[:, nodes]


class SState(NamedTuple):
    nodes: torch.Tensor  # [B, A] active nodes (-1 pad)
    m: torch.Tensor  # [*, B, A]
    i: torch.Tensor
    d: torch.Tensor
    mb: torch.Tensor  # [*, B]
    ib: torch.Tensor
    e: torch.Tensor
    off: torch.Tensor
    off_c: torch.Tensor


def _s_core(dm: DeviceModel, st: SState, cur_nodes, par_logt, init_lp, p_emit,
            prev, self_, cur, valid, renorm: bool) -> SState:
    """One mapping-constrained forward step (ref: forward.rs:276-306 with
    the active set ``cur_nodes``), given the slots' attributes (par_logt
    [*, B, A, D], init_lp [*, B, A], p_emit [B, A]) and the three slot
    lookups: ``prev(v)`` v at each slot's parents in the previous set,
    ``self_(v)`` at the slot's own node there, ``cur(v)`` at its parents in
    the current set."""
    lt = dm.lt
    slot_ok = cur_nodes >= 0
    # combine the source tables first, then look up once: a lookup is a
    # pure selection, so lookup(ladd3(a, b, c)) == ladd3(lookup(a), ...)
    pre_m = _ladd3(lt.MM + st.m, lt.IM + st.i, lt.DM + st.d)
    from_normal = _lse_deg(par_logt + prev(pre_m))
    from_begin = init_lp + _ladd(lt.MM + st.mb, lt.IM + st.ib)[..., None]
    m_new = p_emit + _ladd(from_normal, from_begin)

    pre_i = _ladd3(lt.MI + st.m, lt.II + st.i, lt.DI + st.d)
    i_new = lt.random + self_(pre_i)

    mb_new = torch.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    # deletion closure within the current active set
    pre_d = _ladd(lt.MD + m_new, lt.ID + i_new)
    fd0 = _lse_deg(par_logt + cur(pre_d))
    fd0 = _ladd(fd0, init_lp + _ladd(lt.MD + mb_new, lt.ID + ib_new)[..., None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_deg(par_logt + lt.DD + cur(fdt))
        d_new = _ladd(d_new, fdt)

    m_new = torch.where(slot_ok, m_new, NEG)
    i_new = torch.where(slot_ok, i_new, NEG)
    d_new = torch.where(slot_ok, d_new, NEG)
    e_new = lt.end + _lse_deg(_ladd3(m_new, i_new, d_new))

    off, off_c = st.off, st.off_c
    if renorm:
        shift = _max_shift(m_new, valid)
        m_new, i_new, d_new = (m_new - shift[..., None], i_new - shift[..., None],
                               d_new - shift[..., None])
        mb_new, ib_new, e_new = mb_new - shift, ib_new - shift, e_new - shift
        off, off_c = _kahan(off, off_c, shift)

    v1 = valid[:, None]
    return SState(
        nodes=torch.where(v1, cur_nodes, st.nodes),
        m=torch.where(v1, m_new, st.m), i=torch.where(v1, i_new, st.i),
        d=torch.where(v1, d_new, st.d), mb=torch.where(valid, mb_new, st.mb),
        ib=torch.where(valid, ib_new, st.ib), e=torch.where(valid, e_new, st.e),
        off=torch.where(valid, off, st.off),
        off_c=torch.where(valid, off_c, st.off_c),
    )


def _s_step(dm: DeviceModel, st: SState, cur_nodes: torch.Tensor,
            x: torch.Tensor, valid: torch.Tensor, renorm: bool) -> SState:
    """One mapping-constrained forward step (ref: forward.rs:276-306 with
    ``mapping.nodes(i)`` as the active set); slots are found by matching
    node ids."""
    slot_ok = cur_nodes >= 0
    safe = torch.where(slot_ok, cur_nodes, 0).long()
    par_logt = torch.where(slot_ok[:, :, None], _per_slot(dm.parent_logt, safe, 1),
                           NEG)
    init_lp = torch.where(slot_ok, _per_slot(dm.init_logp, safe, 0), NEG)
    p_emit = torch.where(dm.emission[safe] == x[:, None], dm.lt.match,
                         dm.lt.mismatch)
    par_idx = dm.parent_idx[safe]
    prev = lambda v: _gather_prev(par_idx, st.nodes, v)
    self_ = lambda v: _gather_self(cur_nodes, st.nodes, v)
    cur = lambda v: _gather_prev(par_idx, cur_nodes, v)
    return _s_core(dm, st, cur_nodes, par_logt, init_lp, p_emit, prev, self_,
                   cur, valid, renorm)


def _s_init(dm: DeviceModel, B: int, A: int) -> SState:
    """The mapped forward's start: no active slot, Begin-match 0."""
    shape = _batch_shape(dm, B)
    dt, dev = dm.dtype, dm.device
    z = torch.zeros(shape, dtype=dt, device=dev)
    neg = torch.full(shape, NEG, dtype=dt, device=dev)
    return SState(nodes=torch.full((B, A), -1, dtype=torch.int32, device=dev),
                  m=torch.full(shape + (A,), NEG, dtype=dt, device=dev),
                  i=torch.full(shape + (A,), NEG, dtype=dt, device=dev),
                  d=torch.full(shape + (A,), NEG, dtype=dt, device=dev),
                  mb=z, ib=neg, e=neg, off=z, off_c=z)


@torch.no_grad()
def forward_scores_mapped(dm: DeviceModel, codes: torch.Tensor,
                          lens: torch.Tensor, map_nodes: torch.Tensor,
                          renorm: bool = True) -> torch.Tensor:
    """Log P(read) per read over the mapped active sets only (ref:
    forward.rs:79-89 forward_with_mapping_score_only).  codes [B, L],
    lens [B], map_nodes [B, L, A] (-1 pad), on dm's device.  Returns [B]
    (or [C, B] for a candidate-stacked model)."""
    B, L = codes.shape
    st = _s_init(dm, B, map_nodes.shape[2])
    codes_t = codes.t()
    for p in range(L):
        st = _s_step(dm, st, map_nodes[:, p], codes_t[p], p < lens, renorm)
    return st.e + st.off


class MappedPositions(NamedTuple):
    """Host-precomputed slot positions of a mapping (numpy).

    * map_nodes [B, L, A] int32: active node per slot (-1 pad)
    * prev_pos [B, L, A, D] int16: slot in step l-1 holding parent d of
      slot a (-1 if absent; step 0 has none)
    * cur_pos [B, L, A, D] int16: slot in step l holding parent d
    * self_pos [B, L, A] int16: slot in step l-1 holding this node
    """

    map_nodes: np.ndarray
    prev_pos: np.ndarray
    cur_pos: np.ndarray
    self_pos: np.ndarray


def precompute_positions(map_nodes: np.ndarray, parent_idx: np.ndarray,
                         parent_exists: np.ndarray = None) -> MappedPositions:
    """Build :class:`MappedPositions` with the native builder
    (``csrc/host/positions.cpp``, compiled into the port's build directory).

    ``parent_exists`` masks structurally absent adjacency padding (node id
    0 in the model arrays) so it resolves to -1 instead of matching a real
    slot that holds node 0.  Raises if the native library cannot be built."""
    if parent_exists is not None:
        parent_idx = np.where(parent_exists, parent_idx, -9)
    lib = _build.positions_lib()
    B, L, A = map_nodes.shape
    n, D = parent_idx.shape
    mn = np.ascontiguousarray(map_nodes, dtype=np.int32)
    pi = np.ascontiguousarray(parent_idx, dtype=np.int32)
    prev_pos = np.empty((B, L, A, D), dtype=np.int16)
    cur_pos = np.empty((B, L, A, D), dtype=np.int16)
    self_pos = np.empty((B, L, A), dtype=np.int16)
    rc = lib.dbg_precompute_positions(B, L, A, D, n, mn, pi, prev_pos,
                                      cur_pos, self_pos)
    if rc != 0:
        raise RuntimeError(f"native positions builder failed (rc={rc}, A={A})")
    return MappedPositions(mn, prev_pos, cur_pos, self_pos)


def pad_mappings(mappings, L: int, n_active: int) -> np.ndarray:
    """Stack per-read mapping node arrays into [B, L, A] with -1 padding."""
    B = mappings.n_reads()
    out = np.full((B, L, n_active), -1, dtype=np.int32)
    for b, nodes in enumerate(mappings.nodes):
        Lb, Ab = nodes.shape
        a = min(Ab, n_active)
        out[b, :Lb, :a] = nodes[:, :a]
    return out
