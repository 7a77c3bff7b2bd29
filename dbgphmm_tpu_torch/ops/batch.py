"""Candidate-batched likelihood evaluation.

PyTorch counterpart of ``dbgphmm_tpu/ops/batch.py`` (``_bucket``,
``candidate_log_likelihoods``), single device.  The posterior hill climb
scores many copy-number assignments X against the same reads; all
candidates share the graph's topology (only ``init_logp``,
``parent_logt`` and ``child_logt`` change), so their arrays are stacked
on a leading axis ``[C, 1, n(, D)]`` and one batched pass runs them all,
as ``jax.vmap`` does (ref: SURVEY.md section 2.11; the reference fans out
over neighbours, posterior.rs:504-515).

The JAX module's mesh argument, ``_pad_reads_axis`` (which pads reads for
a mesh) and ``XlaMappedScorer`` (the TPU's fallback scorer, whose role the
K1 twin of ``ops.mapped_scorer`` takes) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..phmm.model import PHMMModel
from .forward import default_dtype, forward_scores, pad_model, to_device
from .sparse import forward_scores_mapped


def _bucket(n: int) -> int:
    """The next power of two >= n (the candidate axis is padded to it)."""
    b = 1
    while b < n:
        b *= 2
    return b


def candidate_log_likelihoods(
    models: Sequence[PHMMModel],
    codes: np.ndarray,
    lens: np.ndarray,
    device,
    dtype: Optional[torch.dtype] = None,
    map_nodes: Optional[np.ndarray] = None,
    positions=None,
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

    Returns [n_candidates] float64."""
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    C = len(models)
    pad = _bucket(C)
    models = [pad_model(m) for m in models]  # shared bucket (same topology)
    models += [models[0]] * (pad - C)
    base = to_device(models[0], device, dtype, pad=False)
    stack = lambda name: torch.as_tensor(
        np.stack([getattr(m, name) for m in models]), dtype=dtype,
        device=device).unsqueeze(1)  # [C, 1, n(, D)]
    dm = dataclasses.replace(base, init_logp=stack("init_logp"),
                             parent_logt=stack("parent_logt"),
                             child_logt=stack("child_logt"))
    on = lambda a: torch.as_tensor(np.asarray(a), device=device)
    codes_t, lens_t = on(codes), on(lens)
    if positions is not None:
        map_nodes = positions.map_nodes
    if map_nodes is not None:
        per_read = forward_scores_mapped(dm, codes_t, lens_t, on(map_nodes))
    else:
        per_read = forward_scores(dm, codes_t, lens_t)  # [pad, B]
    return per_read[:C].to("cpu", torch.float64).numpy().sum(axis=1)
