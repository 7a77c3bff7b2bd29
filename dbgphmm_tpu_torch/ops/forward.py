"""PHMM model on a device, read padding and log-space helpers.

PyTorch counterpart of the model half of ``dbgphmm_tpu/ops/forward.py``
(lines 32-170 and 467-477): the transition constants (:class:`LogTrans`),
the padded per-node arrays (:class:`DeviceModel`) and the host-side padding
of models and reads.  The dense forward/backward scans of that module are
not ported yet (ROADMAP 'Modules to port', item 7).

Dtype policy: float64 on the CPU (parity with the JAX package's CPU path),
float32 on CUDA (the kernels renormalise, so f32 holds 10 kb reads).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..phmm.model import PHMMModel, encode_bases

NEG = float("-inf")

_LT_PARAMS = ("p_MM", "p_IM", "p_DM", "p_MI", "p_II", "p_DI", "p_MD", "p_ID",
              "p_DD", "p_match", "p_mismatch", "p_random", "p_end")


class LogTrans(NamedTuple):
    """Log transition/emission probabilities, each a 0-d tensor."""

    MM: torch.Tensor
    IM: torch.Tensor
    DM: torch.Tensor
    MI: torch.Tensor
    II: torch.Tensor
    DI: torch.Tensor
    MD: torch.Tensor
    ID: torch.Tensor
    DD: torch.Tensor
    match: torch.Tensor
    mismatch: torch.Tensor
    random: torch.Tensor
    end: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """PHMM arrays on one device (one entry per PHMM node = full DBG edge)."""

    emission: torch.Tensor  # int32 [n] (4 = silent)
    init_logp: torch.Tensor  # [n]
    parent_idx: torch.Tensor  # int32 [n, D]
    parent_logt: torch.Tensor  # [n, D]
    child_idx: torch.Tensor  # int32 [n, D]
    child_logt: torch.Tensor  # [n, D]
    lt: LogTrans
    n_max_gaps: int

    @property
    def device(self) -> torch.device:
        return self.init_logp.device

    @property
    def dtype(self) -> torch.dtype:
        return self.init_logp.dtype


def default_dtype(device: Union[str, torch.device]) -> torch.dtype:
    """float64 on the CPU, float32 on an accelerator."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def bucketize(n: int, ratio: float = 1.2, align: int = 128) -> int:
    """Round n up to a geometric bucket (the JAX package's shape buckets)."""
    b = align
    while b < n:
        b = max(b + align, int(-(-b * ratio // align) * align))
    return b


def pad_model(model: PHMMModel, n_bucket: Optional[int] = None,
              d_bucket: Optional[int] = None) -> PHMMModel:
    """Pad node count / degree to buckets with inert entries (silent
    emission, -inf probs, self-parents at node 0)."""
    n, D = model.parent_idx.shape
    nb = n_bucket if n_bucket is not None else bucketize(n)
    db = d_bucket if d_bucket is not None else (
        2 if D <= 2 else (5 if D <= 5 else bucketize(D, align=1)))
    if nb == n and db == D:
        return model

    def pad_nodes(arr, fill):
        out = np.full((nb,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    def pad_adj(idx, logt):
        idx2 = np.zeros((nb, db), dtype=idx.dtype)
        logt2 = np.full((nb, db), -np.inf, dtype=logt.dtype)
        idx2[:n, :D] = idx
        logt2[:n, :D] = logt
        return idx2, logt2

    pi, pl = pad_adj(model.parent_idx, model.parent_logt)
    ci, cl = pad_adj(model.child_idx, model.child_logt)
    return dataclasses.replace(
        model,
        emission=pad_nodes(model.emission, 4),
        init_logp=pad_nodes(model.init_logp, -np.inf),
        parent_idx=pi, parent_logt=pl, child_idx=ci, child_logt=cl,
    )


def _log_trans(values: Sequence[float], device, dtype) -> LogTrans:
    vals = torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=dtype,
                           device=device)
    return LogTrans(*vals.unbind())


def to_device(model: PHMMModel, device: Union[str, torch.device],
              dtype: Optional[torch.dtype] = None, pad: bool = True) -> DeviceModel:
    """Move a host PHMM model to ``device`` (padded like the JAX package)."""
    if dtype is None:
        dtype = default_dtype(device)
    if pad:
        model = pad_model(model)
    logs = model.params.log_transitions()
    f = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                  device=device)
    i = lambda v: torch.as_tensor(np.asarray(v, dtype=np.int32), device=device)
    return DeviceModel(
        emission=i(model.emission),
        init_logp=f(model.init_logp),
        parent_idx=i(model.parent_idx),
        parent_logt=f(model.parent_logt),
        child_idx=i(model.child_idx),
        child_logt=f(model.child_logt),
        lt=_log_trans([logs[k] for k in _LT_PARAMS], device, dtype),
        n_max_gaps=model.params.n_max_gaps,
    )


def device_model_from_numpy(fields: Mapping, device: Union[str, torch.device]
                            ) -> DeviceModel:
    """Build a :class:`DeviceModel` from numpy copies of another model's
    arrays — e.g. ``np.asarray`` of each field of the JAX package's
    ``DeviceModel`` — so that both packages run on the identical model.

    ``fields`` holds ``emission``, ``init_logp``, ``parent_idx``,
    ``parent_logt``, ``child_idx``, ``child_logt``, ``lt`` (the 13 log
    values in :class:`LogTrans` order, or a mapping by field name) and
    ``n_max_gaps``.  The float dtype is that of ``init_logp``."""
    init = np.asarray(fields["init_logp"])
    dtype = torch.float64 if init.dtype == np.float64 else torch.float32
    lt = fields["lt"]
    if isinstance(lt, Mapping):
        lt = [lt[k] for k in LogTrans._fields]
    f = lambda k: torch.tensor(np.asarray(fields[k]), dtype=dtype, device=device)
    i = lambda k: torch.tensor(np.asarray(fields[k], dtype=np.int32), device=device)
    return DeviceModel(
        emission=i("emission"), init_logp=f("init_logp"),
        parent_idx=i("parent_idx"), parent_logt=f("parent_logt"),
        child_idx=i("child_idx"), child_logt=f("child_logt"),
        lt=_log_trans([float(v) for v in np.asarray(lt, dtype=np.float64)],
                      device, dtype),
        n_max_gaps=int(fields["n_max_gaps"]),
    )


def pad_reads(reads: Sequence[bytes], pad_to: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad reads: (codes [B, L] int32 with -1 padding,
    lens [B] int32)."""
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (lens.max() if len(lens) else 0))
    codes = np.full((len(reads), L), -1, dtype=np.int32)
    for b, r in enumerate(reads):
        codes[b, : len(r)] = encode_bases(r)
    return codes, lens


def _ladd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, y)


def _ladd3(x, y, z):
    return torch.logaddexp(torch.logaddexp(x, y), z)


def _ratio_mask(top_logp: torch.Tensor, top_idx: torch.Tensor, max_ratio):
    """Score-ratio selection: keep only slots within ``max_ratio`` log units
    of the per-position max (ref: hint.rs:135-142)."""
    if max_ratio is None:
        return top_logp, top_idx
    thr = top_logp[..., :1] - max_ratio
    keep = torch.isfinite(top_logp) & (top_logp >= thr)
    return (torch.where(keep, top_logp, torch.full_like(top_logp, NEG)),
            torch.where(keep, top_idx, torch.full_like(top_idx, -1)))
