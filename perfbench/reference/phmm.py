"""The profile HMM of a graph and its forward recursion, in plain PyTorch.

Each full edge (k-mer) of a :class:`~perfbench.reference.graph.Graph` is a
PHMM node that emits the k-mer's last base; node e2 follows node e1 when
e1 ends where e2 starts, at a node that is not the terminal.  A node's
weight is its copy number: in the decodes every emitting node counts at
least once ("non_zero"); a scored candidate's copy numbers count as they
are ("normal").  Transitions into e2 are its weight over the summed weight
of its source's out-edges, the start distribution each node's weight over
the total.

:func:`forward` is the forward recursion over Match / Insert / Delete
states with 1 + n_max_gaps rounds of deletions and per-position
renormalisation, for several rows of weights and parameters at once; given
``sets``, each row's states at each position are restricted to that
position's node set (the mapped forward the scorer and the refine
compute).  It runs in whatever dtype it is given: float64 is the
reference, a lower one the benchmark's control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .graph import NULL_BASE, Graph

CODE = np.full(256, 255, dtype=np.int64)
for _i, _b in enumerate(b"ACGT"):
    CODE[_b] = _i
CODE[NULL_BASE] = 4


@dataclass
class Params:
    """``PHMMParams.uniform(p)`` of the upstream program: mismatch, gap
    open and gap extension all p, end 1e-5, up to 4 consecutive
    deletions."""

    p: float
    p_end: float = 1e-5
    n_max_gaps: int = 4

    def logs(self) -> dict:
        p, e = self.p, self.p_end
        lg = lambda v: math.log(v) if v > 0 else float("-inf")
        return dict(MM=lg(1 - 2 * p - e), IM=lg(1 - 2 * p - e),
                    DM=lg(1 - 2 * p - e), MI=lg(p), II=lg(p), DI=lg(p),
                    MD=lg(p), ID=lg(p), DD=lg(p), match=lg(1 - p),
                    mismatch=lg(p), random=lg(0.25), end=lg(e))


@dataclass
class Model:
    """C rows of one graph's PHMM: the same nodes, each row with its own
    weights and parameters."""

    emission: torch.Tensor  # int64 [n]
    init: torch.Tensor  # [C, n]
    par_idx: torch.Tensor  # int64 [n, D]
    par_logt: torch.Tensor  # [C, n, D]
    lt: dict  # name -> [C]
    n_max_gaps: int
    into: torch.Tensor  # [C, n] log transition into each node
    child_idx: torch.Tensor  # int64 [n, Dc], -1 pad


def structure(g: Graph):
    """(emission [n], parents [n, D] (-1 pad)) of the PHMM of ``g``."""
    emission = CODE[g.bases]
    term = -1 if g.terminal is None else g.terminal
    order = np.argsort(g.tgts, kind="stable")
    ins = [[] for _ in range(g.n_nodes)]
    for e in order:
        ins[g.tgts[e]].append(int(e))
    D = max(2, max((len(ins[v]) for v in range(g.n_nodes) if v != term),
                   default=2))
    par = np.full((g.n_edges, D), -1, dtype=np.int64)
    for e2 in range(g.n_edges):
        v = int(g.srcs[e2])
        if v != term:
            par[e2, : len(ins[v])] = ins[v]
    return emission, par


def children(g: Graph) -> np.ndarray:
    """[n, Dc] (-1 pad): the nodes that follow each node (the out-edges of
    its target, unless that is the terminal)."""
    term = -1 if g.terminal is None else g.terminal
    outs = [[] for _ in range(g.n_nodes)]
    for e in np.argsort(g.srcs, kind="stable"):
        outs[g.srcs[e]].append(int(e))
    Dc = max(1, max((len(o) for o in outs), default=1))
    ch = np.full((g.n_edges, Dc), -1, dtype=np.int64)
    for e1 in range(g.n_edges):
        v = int(g.tgts[e1])
        if v != term:
            ch[e1, : len(outs[v])] = outs[v]
    return ch


def degree(g: Graph) -> int:
    """The program's padded model degree: the largest in- or out-degree of
    a node that is not the terminal, at least 2."""
    term = -1 if g.terminal is None else g.terminal
    deg = np.maximum(np.bincount(g.srcs, minlength=g.n_nodes),
                     np.bincount(g.tgts, minlength=g.n_nodes))
    if 0 <= term < g.n_nodes:
        deg[term] = 0
    return max(2, int(deg.max(initial=0)))


def weights_log(g: Graph, emission: np.ndarray, weight: np.ndarray):
    """(init [n], log transition into each node [n]) for node weights."""
    w = np.where(emission < 4, weight, 0).astype(np.float64)
    total = w.sum()
    out_sum = np.bincount(g.srcs, weights=w, minlength=g.n_nodes)[g.srcs]
    with np.errstate(divide="ignore"):
        init = np.where(w > 0, np.log(w) - math.log(max(total, 1.0)), -np.inf)
        into = np.where((w > 0) & (out_sum > 0),
                        np.log(w) - np.log(np.maximum(out_sum, 1.0)), -np.inf)
    return init, into


def model(g: Graph, rows: Sequence, device="cpu",
          dtype=torch.float64) -> Model:
    """The PHMM of ``g``, one row per (compact copy numbers, Params) of
    ``rows``: copy numbers as they are ("normal", a scored candidate), or,
    for None, the graph's own with every emitting node at least once
    ("non_zero", the decodes)."""
    emission, par = structure(g)
    inits, logts, intos = [], [], []
    for copies, _params in rows:
        wt = (np.maximum(g.copy, 1) if copies is None
              else np.asarray(copies, dtype=np.int64)[g.full_to_compact])
        init, into = weights_log(g, emission, wt)
        inits.append(init)
        intos.append(into)
        logts.append(np.where(par >= 0, into[:, None], -np.inf))
    f = lambda a: torch.as_tensor(np.stack(a), dtype=dtype, device=device)
    logs = [p.logs() for _c, p in rows]
    gaps = {p.n_max_gaps for _c, p in rows}
    if len(gaps) != 1:
        raise ValueError("rows of one model share n_max_gaps")
    return Model(
        emission=torch.as_tensor(emission, device=device),
        init=f(inits),
        par_idx=torch.as_tensor(np.maximum(par, 0), device=device),
        par_logt=f(logts),
        lt={k: torch.tensor([d[k] for d in logs], dtype=dtype, device=device)
            for k in logs[0]},
        n_max_gaps=gaps.pop(), into=f(intos),
        child_idx=torch.as_tensor(children(g), device=device))


def _lse(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis that keeps -inf where every term is
    -inf."""
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m.squeeze(-1) + torch.log(torch.exp(x - m).sum(dim=-1))


def _core(lt, st: list, sc: list, neg, plt, init, emit, prev, self_, cur,
          ok, valid, n_max_gaps: int) -> None:
    """One forward step, in place: ``st`` = [m, i, d] [R, B, W] over the
    W cells of this position, ``sc`` = [mb, ib, e, off] [R, B].  ``plt``
    [R, B|1, W, D] are the cells' parent transitions, ``init`` their start
    weights, ``emit`` their emission; ``prev(v)`` / ``cur(v)`` look up a
    [R, B, W] table of the previous / this position at each cell's
    parents ([R, B, W, D], -inf where absent), ``self_(v)`` at the cell's
    own node in the previous position; ``ok`` [R, B, W] marks live cells."""
    st_m, st_i, st_d = st
    mb, ib, e, off = sc
    c3 = lambda k: lt[k][:, None, None]
    c2 = lambda k: lt[k][:, None]
    cut = (lambda v: v) if ok is None else (lambda v: torch.where(ok, v, neg))
    ladd = torch.logaddexp
    pre = ladd(ladd(c3("MM") + st_m, c3("IM") + st_i), c3("DM") + st_d)
    from_begin = init + ladd(c2("MM") + mb, c2("IM") + ib)[..., None]
    m_new = cut(emit + ladd(_lse(plt + prev(pre)), from_begin))
    pre_i = ladd(ladd(c3("MI") + st_m, c3("II") + st_i), c3("DI") + st_d)
    i_new = cut(c3("random") + self_(pre_i))
    ib_new = c2("random") + ladd(c2("MI") + mb, c2("II") + ib)
    d0 = _lse(plt + cur(ladd(c3("MD") + m_new, c3("ID") + i_new)))
    d0 = cut(ladd(d0, init + (c2("ID") + ib_new)[..., None]))
    d_new, dk = d0, d0
    for _ in range(n_max_gaps):
        dk = cut(_lse(plt + c3("DD")[..., None] + cur(dk)))
        d_new = ladd(d_new, dk)
    e_new = c2("end") + _lse(ladd(ladd(m_new, i_new), d_new))
    shift = m_new.amax(dim=-1)
    shift = torch.where(torch.isfinite(shift) & valid, shift,
                        torch.zeros_like(shift))
    v3 = valid[..., None]
    st_m.copy_(torch.where(v3, m_new - shift[..., None], st_m))
    st_i.copy_(torch.where(v3, i_new - shift[..., None], st_i))
    st_d.copy_(torch.where(v3, d_new - shift[..., None], st_d))
    mb.copy_(torch.where(valid, neg, mb))
    ib.copy_(torch.where(valid, ib_new - shift, ib))
    e.copy_(torch.where(valid, e_new - shift, e))
    off.add_(torch.where(valid, shift, torch.zeros_like(shift)))


class _Scan:
    """The forward's state and one step of it, in place, reading position
    ``t`` (a device scalar that the step advances) so that a CUDA graph of
    one step can be replayed along the reads.  Without ``sets`` the state
    spans every node; with ``sets`` [R, B, L, A] (-1 pad) only the nodes of
    each position's set (slots), found through a node -> slot map."""

    def __init__(self, m: Model, codes, lens, sets, keep=None):
        self.m, self.codes, self.lens = m, codes, lens
        dt, dev = m.init.dtype, m.init.device
        R, n = m.init.shape
        B, L = codes.shape
        if sets is not None:  # position -1: no node
            sets = torch.cat([torch.full_like(sets[:, :, :1], -1), sets], 2)
        self.sets = sets
        W = n if sets is None else sets.shape[3]
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.st = [torch.empty((R, B, W), dtype=dt, device=dev)
                   for _ in range(3)]
        self.sc = [torch.empty((R, B), dtype=dt, device=dev) for _ in range(4)]
        self.neg = torch.tensor(float("-inf"), dtype=dt, device=dev)
        # the stored cells of every position: all of them, or (``keep`` an
        # int, every node's state) the top ``keep`` by m + i + d
        self.keep = keep
        if keep is not None:
            K = W if keep == "all" else min(int(keep), n)
            self.tab = [torch.empty((R, B, L, K), dtype=dt, device=dev)
                        for _ in range(3)]
            self.tab_off = torch.empty((R, B, L), dtype=dt, device=dev)
            self.tab_nodes = (torch.empty((R, B, L, K), dtype=torch.long,
                                          device=dev)
                              if keep != "all" else None)
        self.reset()

    def store(self):
        """Write this position's cells (after :meth:`step`'s state update,
        before it advances ``t``)."""
        st = self.st
        if self.keep != "all":
            merged = torch.logaddexp(torch.logaddexp(st[0], st[1]), st[2])
            K = self.tab[0].shape[3]
            # the program's stable descending order: ties keep the lower node
            vals, idx = torch.sort(merged, dim=-1, descending=True, stable=True)
            vals, idx = vals[..., :K], idx[..., :K]
            st = [v.gather(2, idx) for v in st]
            nodes = torch.where(torch.isfinite(vals), idx, -1)
            self.tab_nodes.index_copy_(2, self.t, nodes.unsqueeze(2))
        for buf, v in zip(self.tab, st):
            buf.index_copy_(2, self.t, v.unsqueeze(2))
        self.tab_off.index_copy_(2, self.t, self.sc[3].unsqueeze(2))

    def reset(self):
        m_, i_, d_ = self.st
        mb, ib, e, off = self.sc
        for x in (m_, i_, d_, ib, e):
            x.fill_(float("-inf"))
        mb.zero_()
        off.zero_()
        self.t.zero_()

    def step(self):
        m, neg = self.m, self.neg
        x = self.codes.index_select(1, self.t).squeeze(1)  # [B]
        valid = (self.t < self.lens)[None, :]  # [1, B]
        lt = m.lt
        if self.sets is None:
            gather = lambda v: v[..., m.par_idx]
            emit = torch.where(m.emission[None, None, :] == x[None, :, None],
                               lt["match"][:, None, None],
                               lt["mismatch"][:, None, None])
            _core(lt, self.st, self.sc, neg, m.par_logt[:, None],
                  m.init[:, None], emit, gather, lambda v: v, gather, None,
                  valid, m.n_max_gaps)
        else:
            R, B, _L1, A = self.sets.shape
            n = m.init.shape[1]
            both = self.sets.index_select(2, torch.cat([self.t, self.t + 1]))
            prev_nodes, cur = both[:, :, 0].long(), both[:, :, 1].long()
            ok = cur >= 0
            safe = torch.where(ok, cur, 0)
            slots = torch.arange(A, device=cur.device).expand(R, B, A)

            def slot_map(nodes):  # [R, B, n + 1]: node -> slot, -1 absent
                mp = torch.full((R, B, n + 1), -1, dtype=torch.long,
                                device=cur.device)
                return mp.scatter_(2, torch.where(nodes >= 0, nodes, n), slots)

            pm, cm = slot_map(prev_nodes), slot_map(cur)
            par = m.par_idx[safe]  # [R, B, A, D]
            flat = par.reshape(R, B, -1)

            def look(mp, idx, v):  # v [R, B, A] at slots mp[idx]
                sl = mp.gather(2, idx)
                got = v.gather(2, sl.clamp(min=0))
                return torch.where(sl >= 0, got, neg)

            prev = lambda v: look(pm, flat, v).reshape(par.shape)
            cur_l = lambda v: look(cm, flat, v).reshape(par.shape)
            self_ = lambda v: look(pm, safe, v)
            rows = torch.arange(R, device=cur.device)[:, None, None]
            plt = torch.where(ok[..., None], m.par_logt[rows, safe], neg)
            init = torch.where(ok, m.init[rows, safe], neg)
            emit = torch.where(m.emission[safe] == x[None, :, None],
                               lt["match"][:, None, None],
                               lt["mismatch"][:, None, None])
            _core(lt, self.st, self.sc, neg, plt, init, emit, prev, self_,
                  cur_l, ok, valid, m.n_max_gaps)
        if self.keep is not None:
            self.store()
        self.t.add_(1)


@torch.no_grad()
def forward(m: Model, codes: torch.Tensor, lens: torch.Tensor,
            sets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log P(read) [R, B] of each model row and read.  ``codes`` [B, L]
    int64 (-1 past the read's end), ``lens`` [B]; ``sets`` [R, B, L, A]
    (-1 pad) restricts row r's states at each position to its nodes."""
    scan = _Scan(m, codes, lens, sets)
    _replay(scan, codes.shape[1])
    _mb, _ib, e, off = scan.sc
    return e + off


def _replay(scan, steps: int) -> None:
    """``steps`` of ``scan.step()`` from ``scan.reset()``; on the card one
    step is captured once as a CUDA graph and replayed."""
    dev = scan.codes.device
    if dev.type != "cuda":
        for _ in range(steps):
            scan.step()
        return
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        scan.step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scan.step()
    scan.reset()
    for _ in range(steps):
        graph.replay()


@dataclass
class Tables:
    """A forward's stored cells at every read position: ``nodes`` [R, B, L,
    W] (-1 pad), their normalised ``m``, ``i``, ``d`` and each position's
    offset ``off`` [R, B, L]; ``logp`` [R, B] the forward's total."""

    nodes: torch.Tensor
    m: torch.Tensor
    i: torch.Tensor
    d: torch.Tensor
    off: torch.Tensor
    logp: torch.Tensor


@torch.no_grad()
def tables(m: Model, codes: torch.Tensor, lens: torch.Tensor,
           sets: Optional[torch.Tensor] = None, keep=None) -> Tables:
    """The forward of :func:`forward` with its cells stored at every
    position: with ``sets``, the sets' cells; without, every node's
    (``keep`` None) or the top ``keep`` by m + i + d (the dense-compute
    decode's stored cells)."""
    scan = _Scan(m, codes, lens, sets, "all" if keep is None else keep)
    _replay(scan, codes.shape[1])
    _mb, _ib, e, off = scan.sc
    R, B, L = scan.tab_off.shape
    if sets is not None:
        nodes = sets.long()
    elif scan.tab_nodes is not None:
        nodes = scan.tab_nodes
    else:
        n = m.init.shape[1]
        nodes = torch.arange(n, device=codes.device).expand(R, B, L, n)
    return Tables(nodes, *scan.tab, scan.tab_off, e + off)


class _BScan:
    """The backward over a forward's stored cells, each read from its own
    last position down (step ``s`` reads position len - 1 - s), in the
    program's convention (its R2 and dense backward, ``backward.rs``):
    every state of the last position is worth p_end; a Delete state's
    backward adds up to n_max_gaps further deletions at its position; a
    state's children are looked up only among the stored cells.  Each step
    writes log S = log(F B / P) of its position's cells, summed over M, I
    and D, into ``post`` [R, B, L + 1, W] (column L takes the steps past a
    read's start)."""

    def __init__(self, m: Model, codes, lens, tab: Tables):
        self.m, self.codes, self.lens, self.tab = m, codes, lens, tab
        R, B, L, W = tab.nodes.shape
        dt, dev = tab.m.dtype, codes.device
        self.ar = torch.arange(B, device=dev)
        self.rows = torch.arange(R, device=dev)[:, None, None]
        self.slots = torch.arange(W, device=dev).expand(R, B, W)
        self.s = torch.zeros(1, dtype=torch.long, device=dev)
        self.bm = torch.empty((R, B, W), dtype=dt, device=dev)
        self.bi = torch.empty_like(self.bm)
        self.boff = torch.empty((R, B), dtype=dt, device=dev)
        self.post = torch.empty((R, B, L + 1, W), dtype=dt, device=dev)
        self.neg = torch.tensor(float("-inf"), dtype=dt, device=dev)
        self.reset()

    def at(self, v, j):
        """[R, B, ...] of ``v`` [R, B, L, ...] at each read's position j."""
        return v[:, self.ar, j]

    def reset(self):
        tab, lt = self.tab, self.m.lt
        last = (self.lens - 1).clamp(min=0)
        ok = self.at(tab.nodes, last) >= 0
        end = lt["end"][:, None, None]
        self.bm.copy_(torch.where(ok, end, self.neg))
        self.bi.copy_(self.bm)
        self.boff.zero_()
        self.post.fill_(float("-inf"))
        f3 = torch.logaddexp(torch.logaddexp(self.at(tab.m, last),
                                             self.at(tab.i, last)),
                             self.at(tab.d, last))
        sc = (self.at(tab.off, last) - tab.logp)[..., None]
        self.post[:, self.ar, last] = torch.where(ok, f3 + end + sc, self.neg)
        self.s.fill_(1)

    def step(self):
        m, tab, neg, lt = self.m, self.tab, self.neg, self.m.lt
        R, B, L, W = tab.nodes.shape
        n = m.init.shape[1]
        j = self.lens - 1 - self.s  # [B]
        valid = (j >= 0)[None, :]
        jc = j.clamp(min=0)
        jn = (jc + 1).clamp(max=L - 1)
        x = self.codes.gather(1, jn[:, None]).squeeze(1)  # base at j + 1
        cur, nxt = self.at(tab.nodes, jc), self.at(tab.nodes, jn)
        ok = cur >= 0
        safe = torch.where(ok, cur, 0)

        def slot_map(nodes):  # [R, B, n + 1]: node -> slot, -1 absent
            mp = torch.full((R, B, n + 1), -1, dtype=torch.long,
                            device=cur.device)
            return mp.scatter_(2, torch.where(nodes >= 0, nodes, n),
                               self.slots)

        cm, nm = slot_map(cur), slot_map(nxt)
        ch = m.child_idx[safe]  # [R, B, W, Dc]
        ch_ok = (ch >= 0) & ok[..., None]
        ch_safe = torch.where(ch_ok, ch, 0)
        flat = ch_safe.reshape(R, B, -1)
        t_ch = torch.where(ch_ok, m.into[self.rows[..., None], ch_safe], neg)

        def look(mp, idx, v):  # v [R, B, W] at the slots of nodes idx
            sl = mp.gather(2, idx)
            return torch.where(sl >= 0, v.gather(2, sl.clamp(min=0)), neg)

        c3 = lambda k: lt[k][:, None, None]
        c4 = lambda k: lt[k][:, None, None, None]
        ladd = torch.logaddexp
        emit = torch.where(m.emission[torch.where(nxt >= 0, nxt, 0)]
                           == x[None, :, None], c3("match"), c3("mismatch"))
        nxt_m = look(nm, flat, emit + self.bm).reshape(ch.shape)
        self_i = torch.where(ok, look(nm, safe, self.bi), neg)
        g_d = ladd(c3("DM") + _lse(t_ch + nxt_m),
                   c3("DI") + c3("random") + self_i)
        h, hk = g_d, g_d
        for _ in range(m.n_max_gaps):
            hk = _lse(t_ch + c4("DD") + look(cm, flat, hk).reshape(ch.shape))
            h = ladd(h, hk)
        h = torch.where(ok, h, neg)
        ch_d = look(cm, flat, h).reshape(ch.shape)
        bm = ladd(_lse(t_ch + ladd(c4("MM") + nxt_m, c4("MD") + ch_d)),
                  c3("MI") + c3("random") + self_i)
        bi = ladd(_lse(t_ch + ladd(c4("IM") + nxt_m, c4("ID") + ch_d)),
                  c3("II") + c3("random") + self_i)
        bm, bi = torch.where(ok, bm, neg), torch.where(ok, bi, neg)
        sc = (self.at(tab.off, jc) + self.boff - tab.logp)[..., None]
        s3 = ladd(ladd(self.at(tab.m, jc) + bm, self.at(tab.i, jc) + bi),
                  self.at(tab.d, jc) + h)
        col = torch.where(valid[0], jc, L)
        self.post[:, self.ar, col] = torch.where(ok, s3 + sc, neg)
        shift = bm.amax(dim=-1)
        shift = torch.where(torch.isfinite(shift) & valid, shift,
                            torch.zeros_like(shift))
        v3 = valid[..., None]
        self.bm.copy_(torch.where(v3, bm - shift[..., None], self.bm))
        self.bi.copy_(torch.where(v3, bi - shift[..., None], self.bi))
        self.boff.add_(shift)
        self.s.add_(1)


@torch.no_grad()
def posterior(m: Model, codes: torch.Tensor, lens: torch.Tensor,
              tab: Tables) -> torch.Tensor:
    """log S [R, B, L, W] of ``tab``'s cells: the posterior of each stored
    node at each read position (M + I + D), -inf for absent cells."""
    scan = _BScan(m, codes, lens, tab)
    _replay(scan, max(codes.shape[1] - 1, 0))
    return scan.post[:, :, :-1]


def select(nodes: torch.Tensor, logs: torch.Tensor, k: int, ratio: float):
    """The program's mapping rule on [..., W] cells: the top ``k`` by log S
    (ties keep the lower slot), those within ``ratio`` of the best;
    (nodes, logs) [..., k], -1 / -inf elsewhere."""
    k = min(k, logs.shape[-1])
    v, sl = torch.sort(logs, dim=-1, descending=True, stable=True)
    v, sl = v[..., :k], sl[..., :k]
    nd = nodes.gather(-1, sl)
    keep = torch.isfinite(v) & (v >= v[..., :1] - ratio) & (nd >= 0)
    return torch.where(keep, nd, -1), torch.where(keep, v, float("-inf"))


def encode(reads: Sequence[bytes], device="cpu"):
    """(codes [B, L] int64, -1 past each read's end; lens [B])."""
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), -1, dtype=np.int64)
    for b, r in enumerate(reads):
        codes[b, : len(r)] = CODE[np.frombuffer(r, dtype=np.uint8)]
    return (torch.as_tensor(codes, device=device),
            torch.as_tensor([len(r) for r in reads], device=device))
