"""PHMM model on a device, read padding, and the dense forward/backward.

PyTorch counterpart of ``dbgphmm_tpu/ops/forward.py``: the transition
constants (:class:`LogTrans`), the padded per-node arrays
(:class:`DeviceModel`), the host-side padding of models and reads, and the
dense batched forward/backward recursions with the posterior decode
(``forward_scores``, ``forward_tables``, ``backward_tables``,
``full_prob_backward``, ``node_freqs_and_mappings``; ref:
src/hmmv2/forward.rs, backward.rs, freq.rs, hint.rs).  Each ``lax.scan`` of
the JAX module is a Python loop over read positions; ``lax.top_k`` is the
stable descending sort of ``_top_k`` (ties keep the lower index first).

Per read the state is ``m, i, d`` over the nodes plus the scalars
``mb, ib, e``; with ``renorm`` every step subtracts the per-read maximum of
``m`` and Kahan-sums the offset, so float32 holds arbitrarily long reads.
The recursions broadcast the model's per-node arrays against the state, so
a model whose ``init_logp`` is ``[C, 1, n]`` and whose ``parent_logt`` /
``child_logt`` are ``[C, 1, n, D]`` runs C candidates at once (states
``[C, B, n]``; ``ops.batch``).

Dtype policy: float64 on the CPU (parity with the JAX package's CPU path),
float32 on CUDA (the recursions renormalise, so f32 holds 10 kb reads).
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


def _lse_deg(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis, -inf safe."""
    m = x.amax(dim=-1)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    out = m_safe + torch.log(torch.exp(x - m_safe[..., None]).sum(dim=-1))
    return torch.where(fin, out, torch.full_like(out, NEG))


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: descending, ties keep the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _s_log(s_lin: torch.Tensor) -> torch.Tensor:
    """log of a linear posterior, -inf where it is 0 or subnormal (XLA
    flushes subnormals to zero, so the JAX package sees those as 0)."""
    tiny = torch.finfo(s_lin.dtype).tiny
    return torch.where(s_lin >= tiny, torch.log(torch.clamp(s_lin, min=1e-300)),
                       NEG)


def _ratio_mask(top_logp: torch.Tensor, top_idx: torch.Tensor, max_ratio):
    """Score-ratio selection: keep only slots within ``max_ratio`` log units
    of the per-position max (ref: hint.rs:135-142)."""
    if max_ratio is None:
        return top_logp, top_idx
    thr = top_logp[..., :1] - max_ratio
    keep = torch.isfinite(top_logp) & (top_logp >= thr)
    return (torch.where(keep, top_logp, torch.full_like(top_logp, NEG)),
            torch.where(keep, top_idx, torch.full_like(top_idx, -1)))


def _max_shift(m: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The renormalisation shift: each read's maximum of ``m``, 0 where it
    is -inf or the position is padding."""
    shift = m.amax(dim=-1)
    return torch.where(torch.isfinite(shift) & valid, shift, torch.zeros_like(shift))


def _kahan(off, off_c, shift):
    """Add ``shift`` to the Kahan-compensated sum (off, off_c)."""
    y = shift - off_c
    t = off + y
    return t, (t - off) - y


def _batch_shape(dm: DeviceModel, B: int):
    """Leading state shape: (B,) for one model, (C, B) for a stacked one."""
    return torch.broadcast_shapes(tuple(dm.init_logp.shape[:-1]), (B,))


# -- forward ------------------------------------------------------------------


class FState(NamedTuple):
    m: torch.Tensor  # [*, B, n]
    i: torch.Tensor
    d: torch.Tensor
    mb: torch.Tensor  # [*, B]
    ib: torch.Tensor
    e: torch.Tensor
    off: torch.Tensor  # cumulative renorm offset
    off_c: torch.Tensor  # Kahan compensation


def _f_init(shape, n: int, dtype, device) -> FState:
    """F[0]: every node -inf, Begin-match 0 (log 1)."""
    shape = tuple(shape)
    z = torch.zeros(shape, dtype=dtype, device=device)
    neg = torch.full(shape + (n,), NEG, dtype=dtype, device=device)
    negb = torch.full(shape, NEG, dtype=dtype, device=device)
    return FState(m=neg, i=neg, d=neg, mb=z, ib=negb, e=negb, off=z, off_c=z)


def _p_match_emit(dm: DeviceModel, x: torch.Tensor) -> torch.Tensor:
    """[B, n] log emission prob of observing x from Match of each node
    (ref: common.rs:168-174)."""
    return torch.where(dm.emission[None, :] == x[:, None], dm.lt.match,
                       dm.lt.mismatch)


def _f_step(dm: DeviceModel, st: FState, x: torch.Tensor, valid: torch.Tensor,
            renorm: bool, pidx: torch.Tensor) -> FState:
    """One forward emission step (ref: forward.rs:276-306 f_step).
    ``pidx`` is ``dm.parent_idx`` as int64."""
    lt = dm.lt
    inner = _ladd3(lt.MM + st.m[..., pidx], lt.IM + st.i[..., pidx],
                   lt.DM + st.d[..., pidx])
    from_normal = _lse_deg(dm.parent_logt + inner)
    from_begin = dm.init_logp + _ladd(lt.MM + st.mb, lt.IM + st.ib)[..., None]
    m_new = _p_match_emit(dm, x) + _ladd(from_normal, from_begin)

    i_new = lt.random + _ladd3(lt.MI + st.m, lt.II + st.i, lt.DI + st.d)

    mb_new = torch.full_like(st.mb, NEG)
    ib_new = lt.random + _ladd(lt.MI + st.mb, lt.II + st.ib)

    # deletion closure, 1 + n_max_gaps rounds (forward.rs:423-524)
    fd0 = _lse_deg(dm.parent_logt + _ladd(lt.MD + m_new[..., pidx],
                                          lt.ID + i_new[..., pidx]))
    fd0 = _ladd(fd0, dm.init_logp + _ladd(lt.MD + mb_new,
                                          lt.ID + ib_new)[..., None])
    d_new = fd0
    fdt = fd0
    for _ in range(dm.n_max_gaps):
        fdt = _lse_deg(dm.parent_logt + lt.DD + fdt[..., pidx])
        d_new = _ladd(d_new, fdt)

    e_new = lt.end + _lse_deg(_ladd3(m_new, i_new, d_new))

    off, off_c = st.off, st.off_c
    if renorm:
        shift = _max_shift(m_new, valid)
        m_new, i_new, d_new = (m_new - shift[..., None], i_new - shift[..., None],
                               d_new - shift[..., None])
        mb_new, ib_new, e_new = mb_new - shift, ib_new - shift, e_new - shift
        off, off_c = _kahan(off, off_c, shift)

    v1 = valid[:, None]
    return FState(
        m=torch.where(v1, m_new, st.m), i=torch.where(v1, i_new, st.i),
        d=torch.where(v1, d_new, st.d), mb=torch.where(valid, mb_new, st.mb),
        ib=torch.where(valid, ib_new, st.ib), e=torch.where(valid, e_new, st.e),
        off=torch.where(valid, off, st.off),
        off_c=torch.where(valid, off_c, st.off_c),
    )


def _f_scan(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
            renorm: bool, keep: bool):
    """The forward scan: (final state, tables or None); ``tables`` is an
    FState with a leading position axis, tables[t] = F[t+1]."""
    B, L = codes.shape
    st = _f_init(_batch_shape(dm, B), dm.emission.shape[0], dm.dtype, dm.device)
    tabs = FState(*[torch.empty((L,) + a.shape, dtype=a.dtype, device=a.device)
                    for a in st]) if keep else None
    pidx = dm.parent_idx.long()
    codes_t = codes.t()
    for p in range(L):
        st = _f_step(dm, st, codes_t[p], p < lens, renorm, pidx)
        if keep:
            for tab, a in zip(tabs, st):
                tab[p] = a
    return st, tabs


@torch.no_grad()
def forward_scores(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                   renorm: bool = True) -> torch.Tensor:
    """Log P(read) per read, score-only forward (ref: forward.rs:158-206).
    ``codes`` [B, L] int with -1 padding, ``lens`` [B], on dm's device;
    returns [B] (or [C, B] for a candidate-stacked model)."""
    st, _ = _f_scan(dm, codes, lens, renorm, keep=False)
    return st.e + st.off


@torch.no_grad()
def forward_tables(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                   renorm: bool = True):
    """Full forward pass storing per-position tables: ``(final_state,
    tables)``, tables an FState with a leading [L] axis, tables[t] = F[t+1]
    (padded positions carry the read's last state forward)."""
    return _f_scan(dm, codes, lens, renorm, keep=True)


# -- backward -----------------------------------------------------------------


class BState(NamedTuple):
    m: torch.Tensor  # [*, B, n]
    i: torch.Tensor
    d: torch.Tensor
    mb: torch.Tensor  # [*, B]
    ib: torch.Tensor
    off: torch.Tensor
    off_c: torch.Tensor


def _b_init(dm: DeviceModel, shape, n: int, dtype) -> BState:
    """ref: backward.rs:197-211 — m = i = d = p_end, mb = ib = -inf."""
    shape = tuple(shape)
    pe = torch.full(shape + (n,), float(dm.lt.end), dtype=dtype, device=dm.device)
    neg = torch.full(shape, NEG, dtype=dtype, device=dm.device)
    z = torch.zeros(shape, dtype=dtype, device=dm.device)
    return BState(m=pe, i=pe, d=pe, mb=neg, ib=neg, off=z, off_c=z)


def _b_step(dm: DeviceModel, st: BState, x: torch.Tensor, valid: torch.Tensor,
            renorm: bool, cidx: torch.Tensor) -> BState:
    """One backward step for emission x (ref: backward.rs:216-261 b_step):
    ``st`` is B[i+1], the result B[i].  ``cidx`` is ``dm.child_idx`` as
    int64."""
    lt = dm.lt
    p_emit = _p_match_emit(dm, x)  # [B, n]
    p_emit_child = p_emit[:, cidx]  # [B, n, D]
    bm_next_child = st.m[..., cidx]

    bd0 = _lse_deg(dm.child_logt + lt.DM + p_emit_child + bm_next_child)
    bd0 = _ladd(bd0, lt.DI + lt.random + st.i)
    d_new = bd0
    bdt = bd0
    for _ in range(dm.n_max_gaps):
        bdt = _lse_deg(dm.child_logt + lt.DD + bdt[..., cidx])
        d_new = _ladd(d_new, bdt)

    bd_child = d_new[..., cidx]
    m_new = _lse_deg(dm.child_logt + _ladd(lt.MM + p_emit_child + bm_next_child,
                                           lt.MD + bd_child))
    m_new = _ladd(m_new, lt.MI + lt.random + st.i)
    i_new = _lse_deg(dm.child_logt + _ladd(lt.IM + p_emit_child + bm_next_child,
                                           lt.ID + bd_child))
    i_new = _ladd(i_new, lt.II + lt.random + st.i)

    # begin states over all nodes (backward.rs:499-555)
    mb_new = _lse_deg(dm.init_logp + _ladd(lt.MM + p_emit + st.m, lt.MD + d_new))
    mb_new = _ladd(mb_new, lt.MI + lt.random + st.ib)
    ib_new = _lse_deg(dm.init_logp + _ladd(lt.IM + p_emit + st.m, lt.ID + d_new))
    ib_new = _ladd(ib_new, lt.II + lt.random + st.ib)

    off, off_c = st.off, st.off_c
    if renorm:
        shift = _max_shift(m_new, valid)
        m_new, i_new, d_new = (m_new - shift[..., None], i_new - shift[..., None],
                               d_new - shift[..., None])
        mb_new, ib_new = mb_new - shift, ib_new - shift
        off, off_c = _kahan(off, off_c, shift)

    v1 = valid[:, None]
    return BState(
        m=torch.where(v1, m_new, st.m), i=torch.where(v1, i_new, st.i),
        d=torch.where(v1, d_new, st.d), mb=torch.where(valid, mb_new, st.mb),
        ib=torch.where(valid, ib_new, st.ib),
        off=torch.where(valid, off, st.off),
        off_c=torch.where(valid, off_c, st.off_c),
    )


def _reverse_codes(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-read reversal within its own length; padding stays at the tail."""
    B, L = codes.shape
    idx = lens.long()[:, None] - 1 - torch.arange(L, device=codes.device)[None, :]
    rev = torch.gather(codes, 1, idx.clamp(0, max(L - 1, 0)))
    return torch.where(idx >= 0, rev, torch.full_like(rev, -1))


@torch.no_grad()
def backward_tables(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                    renorm: bool = True, keep: bool = True):
    """Full backward pass: ``(final_state, tables)``.  ``tables`` has a
    leading [L] axis in reversed scan order, tables[t] = B[len_b - 1 - t]
    for read b (valid for t < len_b); ``final_state`` is B[0].  With
    ``keep=False`` no tables are stored (None)."""
    B, L = codes.shape
    st = _b_init(dm, _batch_shape(dm, B), dm.emission.shape[0], dm.dtype)
    tabs = BState(*[torch.empty((L,) + a.shape, dtype=a.dtype, device=a.device)
                    for a in st]) if keep else None
    cidx = dm.child_idx.long()
    xs_t = _reverse_codes(codes, lens).t()
    for t in range(L):
        st = _b_step(dm, st, xs_t[t], t < lens, renorm, cidx)
        if keep:
            for tab, a in zip(tabs, st):
                tab[t] = a
    return st, tabs


def full_prob_backward(dm: DeviceModel, codes: torch.Tensor, lens: torch.Tensor,
                       renorm: bool = True) -> torch.Tensor:
    """Log P(read) from the backward pass (= B[0].mb, ref: table.rs:395-401)."""
    final, _ = backward_tables(dm, codes, lens, renorm=renorm, keep=False)
    return final.mb + final.off


# -- posterior decode: node freqs and mappings ---------------------------------


def _scatter_positions(tops_logp, tops_idx, i_merges, valids, L: int):
    """Scan-order per-step top-k ([L, B, k], S index i of read b at step t)
    into read-position order [B, L, k]: S index i holds read position i - 1;
    entries that are not valid go to a dropped column L (the JAX scatter's
    ``mode="drop"``).  Returns the (L + 1)-wide buffers (map_logp,
    map_nodes)."""
    Ls, B, k = tops_logp.shape
    dev = tops_logp.device
    j_pos = i_merges - 1
    j_write = torch.where((j_pos >= 0) & valids, j_pos, L)
    map_logp = torch.full((B, L + 1, k), NEG, dtype=tops_logp.dtype, device=dev)
    map_nodes = torch.full((B, L + 1, k), -1, dtype=torch.int32, device=dev)
    batch_ix = torch.arange(B, device=dev)[None, :].expand(Ls, B)
    map_logp[batch_ix, j_write] = tops_logp
    map_nodes[batch_ix, j_write] = tops_idx
    return map_logp, map_nodes


def _put_last(map_logp, map_nodes, last_logp, last_idx, lens, L: int):
    """Write read position len - 1 (S[len]) of every read (a read of
    length 0 writes to the dropped column) and cut the buffers to L:
    (map_nodes [B, L, k], map_logp [B, L, k])."""
    lens_l = lens.long()
    ar = torch.arange(lens.shape[0], device=lens.device)
    j_last = torch.where(lens_l > 0, lens_l - 1, L)
    map_logp[ar, j_last] = last_logp
    map_nodes[ar, j_last] = last_idx
    return map_nodes[:, :L], map_logp[:, :L]


@torch.no_grad()
def node_freqs_and_mappings(dm: DeviceModel, codes: torch.Tensor,
                            lens: torch.Tensor, renorm: bool = True,
                            n_active: int = 40, max_ratio: Optional[float] = None):
    """Posterior state decoding: expected node usages and the per-position
    top-k mapping (ref: freq.rs:245 to_node_freqs, hint.rs:124-142).

    Returns (logp [B], node_freqs [B, n] linear, map_nodes [B, L, k] int32,
    map_logp [B, L, k]) with k = min(n_active, n); the entries of read
    position j are the top nodes of S[j+1] = F[j+1] * B[j+1] / P, -1 / -inf
    past the read's length.  Keeps the forward tables, 3 x [L, B, n]."""
    B, L = codes.shape
    n = dm.emission.shape[0]
    k = min(n_active, n)
    dt, dev = dm.dtype, dm.device
    ar = torch.arange(B, device=dev)
    lens_l = lens.long()

    f_final, f_tabs = forward_tables(dm, codes, lens, renorm=renorm)
    logp = f_final.e + f_final.off

    bst = _b_init(dm, (B,), n, dt)
    scale = (f_final.off - logp)[:, None]
    s_last = (torch.exp(f_final.m + bst.m + scale)
              + torch.exp(f_final.i + bst.i + scale)
              + torch.exp(f_final.d + bst.d + scale))
    freq = s_last.clone()

    tops_logp = torch.empty((L, B, k), dtype=dt, device=dev)
    tops_idx = torch.empty((L, B, k), dtype=torch.int32, device=dev)
    i_merges = torch.empty((L, B), dtype=torch.long, device=dev)
    valids = torch.empty((L, B), dtype=torch.bool, device=dev)
    cidx = dm.child_idx.long()
    xs_t = _reverse_codes(codes, lens).t()
    for t in range(L):
        valid = t < lens
        bst = _b_step(dm, bst, xs_t[t], valid, renorm, cidx)
        # bst is B[i], i = len_b - 1 - t; F[i] is F[0] (i == 0) or tables[i-1]
        i_merge = lens_l - 1 - t
        i_f = (i_merge - 1).clamp(0, L - 1)
        is_init = (i_merge == 0)[:, None]
        fm = torch.where(is_init, NEG, f_tabs.m[i_f, ar])
        fi = torch.where(is_init, NEG, f_tabs.i[i_f, ar])
        fd = torch.where(is_init, NEG, f_tabs.d[i_f, ar])
        foff = torch.where(i_merge == 0, 0.0, f_tabs.off[i_f, ar])
        sc = (foff + bst.off - logp)[:, None]
        s_lin = (torch.exp(fm + bst.m + sc) + torch.exp(fi + bst.i + sc)
                 + torch.exp(fd + bst.d + sc))
        freq = freq + torch.where(valid[:, None], s_lin, 0.0)
        top_logp, top_idx = _top_k(_s_log(s_lin), k)
        top_idx = torch.where(torch.isfinite(top_logp), top_idx, -1)
        tops_logp[t], tops_idx[t] = _ratio_mask(top_logp, top_idx, max_ratio)
        i_merges[t], valids[t] = i_merge, valid
    # S[0] (Begin x Begin) holds no node

    map_logp, map_nodes = _scatter_positions(tops_logp, tops_idx, i_merges,
                                             valids, L)
    last_logp, last_idx = _top_k(_s_log(s_last), k)
    last_idx = torch.where(torch.isfinite(last_logp), last_idx, -1)
    last_logp, last_idx = _ratio_mask(last_logp, last_idx, max_ratio)
    map_nodes, map_logp = _put_last(map_logp, map_nodes, last_logp,
                                    last_idx.to(torch.int32), lens, L)
    return logp, freq, map_nodes, map_logp
