"""Mapping-constrained helpers: slot positions, mapping padding and the
active-set gathers.

PyTorch counterpart of the parts of ``dbgphmm_tpu/ops/sparse.py`` that the
seeded inference path runs: :class:`MappedPositions` and
``precompute_positions`` (the native builder ``csrc/host/positions.cpp``),
``pad_mappings``, and the equality-match gathers ``_gather_prev`` /
``_gather_self`` used by the refine scan (ops/adaptive.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .forward import NEG


def _gather_prev(parent_idx: torch.Tensor, prev_nodes: torch.Tensor,
                 prev_vals: torch.Tensor) -> torch.Tensor:
    """For each (b, a, d): prev_vals at the slot of prev_nodes that holds
    node parent_idx[b, a, d], or -inf if absent.

    parent_idx [B, A, D] int; prev_nodes [B, A'] int (-1 pad);
    prev_vals [B, A'] -> [B, A, D]."""
    match = parent_idx[:, :, :, None] == prev_nodes[:, None, None, :]
    vals = torch.where(match, prev_vals[:, None, None, :],
                       torch.full((), NEG, dtype=prev_vals.dtype,
                                  device=prev_vals.device))
    return vals.amax(dim=-1)


def _gather_self(cur_nodes: torch.Tensor, prev_nodes: torch.Tensor,
                 prev_vals: torch.Tensor) -> torch.Tensor:
    """prev_vals at each current node's slot in the previous set (or -inf):
    [B, A]."""
    match = cur_nodes[:, :, None] == prev_nodes[:, None, :]
    vals = torch.where(match, prev_vals[:, None, :],
                       torch.full((), NEG, dtype=prev_vals.dtype,
                                  device=prev_vals.device))
    return vals.amax(dim=-1)


def _lse_last(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis, -inf safe."""
    m = x.amax(dim=-1)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    out = m_safe + torch.log(torch.exp(x - m_safe[..., None]).sum(dim=-1))
    return torch.where(fin, out, torch.full_like(out, NEG))


class SState(NamedTuple):
    nodes: torch.Tensor  # [B, A] active nodes (-1 pad)
    m: torch.Tensor  # [B, A]
    i: torch.Tensor
    d: torch.Tensor
    mb: torch.Tensor  # [B]
    ib: torch.Tensor  # [B]
    e: torch.Tensor  # [B]
    off: torch.Tensor  # [B]
    off_c: torch.Tensor


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
