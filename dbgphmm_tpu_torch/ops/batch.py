"""Candidate-batched likelihood evaluation.

PyTorch counterpart of ``dbgphmm_tpu/ops/batch.py`` (``_bucket``,
``candidate_log_likelihoods``, ``_pad_reads_axis``).  The posterior hill
climb scores many copy-number assignments X against the same reads; all
candidates share the graph's topology (only ``init_logp``,
``parent_logt`` and ``child_logt`` change), so their arrays are stacked
on a leading axis ``[C, 1, n(, D)]`` and one batched pass runs them all,
as ``jax.vmap`` does (ref: SURVEY.md section 2.11; the reference fans out
over neighbours, posterior.rs:504-515).  With a mesh the candidates split
along its "cand" axis and the reads along "reads".

The JAX module's ``XlaMappedScorer`` (the TPU's fallback scorer, whose
role the K1 twin of ``ops.mapped_scorer`` takes) has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.sharding import _pad_to_multiple, candidate_per_read, local_mesh
from ..phmm.model import PHMMModel
from .forward import default_dtype, pad_model, to_device


def _bucket(n: int) -> int:
    """The next power of two >= n (the candidate axis is padded to it)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_reads_axis(arr: np.ndarray, m: int, fill):
    """Pad axis 0 (reads) to a multiple of m."""
    return _pad_to_multiple(arr, m, 0, fill)


def candidate_log_likelihoods(
    models: Sequence[PHMMModel],
    codes: np.ndarray,
    lens: np.ndarray,
    device,
    dtype: Optional[torch.dtype] = None,
    map_nodes: Optional[np.ndarray] = None,
    positions=None,
    mesh=None,
) -> np.ndarray:
    """Total log P(R | X_c) = sum over reads of log P(read | X_c) for each
    candidate model (same topology, different probabilities), on
    ``device`` in ``dtype`` (default: float64 on the CPU, float32 on CUDA).

    Three branches: the dense forward (``forward_scores``); with
    ``map_nodes`` [B, L, A] the mapping-constrained forward (ref:
    freq.rs:175-192); with ``positions`` (a ``MappedPositions``) the same
    forward over its map_nodes (the JAX package's
    ``forward_scores_mapped_pos`` looks the slots up where this matches
    node ids; the values are the same).  The candidate axis is
    padded to a power of two with copies of candidate 0.

    ``mesh`` (a :class:`~dbgphmm_tpu_torch.parallel.Mesh` of ``device``'s
    type; default the 1 x 1 mesh of ``device``): the candidates, padded
    further to a multiple of the "cand" axis, split along it and the
    reads, padded with zero-length reads, along "reads"; each shard runs
    its block on its device, and the per-read blocks are gathered and
    summed on the host.

    Returns [n_candidates] float64."""
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    mesh = local_mesh(device) if mesh is None else mesh
    if mesh.device_type != device.type:
        raise ValueError(f"{device.type} scoring on a {mesh.device_type} mesh")
    C = len(models)
    pad = -(-_bucket(C) // mesh.shape["cand"]) * mesh.shape["cand"]
    models = [pad_model(m) for m in models]  # shared bucket (same topology)
    models += [models[0]] * (pad - C)
    if positions is not None:
        map_nodes = positions.map_nodes
    rows = {f: torch.as_tensor(np.stack([getattr(m, f) for m in models]),
                               dtype=dtype)
            for f in ("init_logp", "parent_logt", "child_logt")}
    per_read = candidate_per_read(
        to_device(models[0], "cpu", dtype, pad=False), rows, np.asarray(codes),
        np.asarray(lens), mesh, map_nodes)
    return per_read[:C].sum(axis=1)
