"""Exact-match seeded mapping generation.

The reference derives per-base candidate state sets ("mappings",
src/hmmv2/hint.rs:27-142) from a full posterior decode of every read — an
O(L * n) sparse DP per read that its rayon pool makes tolerable.  On this
platform the equivalent full decode is the fragile part: the dense-compute
kernel faults above n≈33k (docs/ACCURACY_NOTES round 4) and the
evolving-frontier kernel silently loses the true path in the
repeat-ambiguous k≈40-50 regime (diagnosed round 5: every n4b production
mapping from k=40 on was absorbed junk — top-1 stuck on one node at
p≈0.005, read likelihoods at the -8.6 nats/base begin-re-entry floor).

This module replaces the *candidate generation* step with graph-exact
k-mer matching, which is both assembler-native and numerically trivial:

* a PHMM state for read base i is the graph k-mer ENDING at i; its
  length-s suffix (s = min(k0, k)) is a hash key — the table maps every
  full edge's k-mer suffix to the edges sharing it (suffixes are computed
  in O(n * s) by vectorized predecessor walks, never materializing
  k-length strings, so this works unchanged at k = 10,000+);
* at error-free positions the table lookup returns a candidate set that
  provably contains the true state (suffix match is necessary for k-mer
  match); width = #repeat copies sharing the suffix — the same ambiguity
  the reference's decode keeps within its score ratio;
* positions whose key is absent (sequencing errors, purged true k-mers)
  are bridged by bounded forward/backward graph walks between the
  flanking seeds, with +-delta slack for indels;
* the seeded sets then run through the hint-constrained refine kernel
  (ops.adaptive.mappings_refine — the reference's run_with_mapping,
  hint.rs:206-216) which assigns calibrated per-candidate posteriors and
  the read's constrained log-likelihood.

Cost: O(B * L) hash lookups + O(errors * width) bridging on host, plus the
O(B * L * A^2) refine on device — independent of graph size n.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..seq.collection import NULL_BASE

SEED_S = 32  # suffix key length (min'd with k); 32 keeps keys unique up to
# repeat multiplicity on HiFi-scale genomes while making error gaps short
BRIDGE_DELTA = 4  # indel slack when intersecting walk distances (n_max_gaps)
BRIDGE_CAP = 256  # per-depth walk frontier cap
WIDTH_CAP = 64  # per-position candidate cap after bridging


class SeedIndex:
    """Suffix-key index over the full graph's edges (k-mer states)."""

    def __init__(self, dbg, s: int = SEED_S):
        fa = dbg._full_arrays()
        self.s = s = min(s, dbg.k)
        self.n_edges = len(fa.srcs)
        srcs, tgts, bases = fa.srcs, fa.tgts, fa.bases

        # one in-edge per node (all in-paths spell the same (k-1)-mer)
        order = np.argsort(tgts, kind="stable")
        first = np.ones(len(order), dtype=bool)
        st = tgts[order]
        first[1:] = st[1:] != st[:-1]
        pred_edge = np.full(fa.n_nodes, -1, dtype=np.int64)
        pred_edge[st[first]] = order[first]

        # last (s-1) bases of every node's (k-1)-mer by predecessor walk
        m = s - 1
        suf = np.full((fa.n_nodes, m), NULL_BASE, dtype=np.uint8)
        cur = np.arange(fa.n_nodes, dtype=np.int64)
        alive = np.ones(fa.n_nodes, dtype=bool)
        for j in range(m - 1, -1, -1):
            e = np.where(alive, pred_edge[cur], -1)
            alive = e >= 0
            es = np.where(alive, e, 0)
            suf[alive, j] = bases[es][alive]
            cur = np.where(alive, srcs[es], cur)

        # edge key = src-node suffix + edge base  -> edges sharing it
        keys = np.concatenate(
            [suf[srcs], bases.astype(np.uint8)[:, None]], axis=1
        )  # [E, s]
        self.keys = keys  # kept for hamming-filtered chain propagation
        self.table = {}
        kb = keys.tobytes()
        valid = ~(keys == NULL_BASE).any(axis=1)
        for e in np.flatnonzero(valid):
            key = kb[e * s : (e + 1) * s]
            self.table.setdefault(key, []).append(int(e))
        for key in self.table:
            self.table[key] = np.asarray(self.table[key], dtype=np.int64)

        # edge-level adjacency as padded [E, 4] tables (DBG in/out degree
        # <= alphabet size 4): successor edges of e = out-edges of tgt[e].
        # One gather per walk step instead of per-node CSR slicing — the
        # seeding hot loop runs these ~L times per read.
        def _pad4(key_nodes, order_arr):
            # order_arr: edge ids sorted by key_nodes[edge]; build
            # [n_nodes, 4] edge table then index by key per edge
            ks = key_nodes[order_arr]
            first = np.ones(len(order_arr), dtype=bool)
            first[1:] = ks[1:] != ks[:-1]
            run_start = np.maximum.accumulate(
                np.where(first, np.arange(len(order_arr)), 0)
            )
            rank = np.arange(len(order_arr)) - run_start
            tab = np.full((fa.n_nodes, 4), -1, dtype=np.int64)
            ok = rank < 4
            tab[ks[ok], rank[ok]] = order_arr[ok]
            return tab

        eorder = np.argsort(srcs, kind="stable")
        node_out = _pad4(srcs, eorder)  # [n_nodes, 4] out-edges per node
        node_in = _pad4(tgts, order)  # [n_nodes, 4] in-edges per node
        self._succ_pad = node_out[tgts]  # [E, 4] successor edges of e
        self._pred_pad = node_in[srcs]  # [E, 4] predecessor edges of e
        self._srcs, self._tgts = srcs, tgts

    def lookup(self, key: bytes):
        return self.table.get(key)

    def succ_edges(self, edges: np.ndarray) -> np.ndarray:
        """All successor edges of ``edges`` (dedup, capped)."""
        nxt = self._succ_pad[edges].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        return nxt[:BRIDGE_CAP]

    def pred_edges(self, edges: np.ndarray) -> np.ndarray:
        """All predecessor edges of ``edges`` (dedup, capped)."""
        prv = self._pred_pad[edges].ravel()
        prv = np.unique(prv[prv >= 0])
        return prv[:BRIDGE_CAP]


# -- scored chain DP ----------------------------------------------------------

CHAIN_DECAY = 0.8  # per-position decay of the accumulated mismatch cost
CHAIN_CMAX = 3.0  # prune a chain whose decayed mismatch cost exceeds this
CHAIN_STAY = 1.5  # stay-in-place (read insertion) cost; > mismatch cost so
# transient I-shadow chains die in 2-3 steps instead of bloating width
PASS_WIDTH = 32  # per-pass lowest-cost retention
UNION_WIDTH = 32  # final per-position cap (lowest combined cost wins):
# bounds the refine kernel's O(A^2) step and keeps the packed scorer at
# A=32 lane packing; true-path candidates ride at near-zero cost and are
# never the ones trimmed
CHAIN_HIT_COST = 0.0  # exact 32-suffix matches (re-)enter at zero cost


def _combine(ids_list, costs_list, cmax: float, width: int):
    """Min-cost merge of candidate (edge, cost) moves, pruned and capped."""
    ids = np.concatenate(ids_list)
    costs = np.concatenate(costs_list)
    ok = (ids >= 0) & (costs <= cmax)
    ids, costs = ids[ok], costs[ok]
    if ids.size == 0:
        return ids, costs
    order = np.lexsort((costs, ids))
    ids, costs = ids[order], costs[order]
    first = np.ones(ids.size, dtype=bool)
    first[1:] = ids[1:] != ids[:-1]
    ids, costs = ids[first], costs[first]
    if ids.size > width:
        sel = np.argpartition(costs, width)[:width]
        ids, costs = ids[sel], costs[sel]
    return ids, costs


def _scored_pass(idx: SeedIndex, rb: np.ndarray, hits: dict,
                 forward: bool):
    """One directional pass of the seed-anchored scored chain DP.

    State: a small set of candidate edges with a decayed mismatch cost.
    Moves per read position mirror the PHMM's structure — one graph step
    with an emission check (M), stay-in-place at +1 (I / read insertion),
    skip a graph step at +1 (D / read deletion) — and exact suffix hits
    (re-)enter at cost 0.  A chain on the wrong locus mismatches ~75% of
    bases and dies within ~1/(1-CHAIN_DECAY) positions; the true chain
    rides through error/divergence clusters the way the reference's
    score-ratio decode does (hint.rs:135-142).  This one mechanism
    subsumes the gap bridging, boundary augmentation, and connectivity
    repair of earlier drafts — and unlike them it cannot hard-pin onto a
    false seed, because hits add candidates without excluding chains."""
    L = len(rb)
    emis = idx.keys[:, -1]
    step = idx._succ_pad if forward else idx._pred_pad
    order = range(L) if forward else range(L - 1, -1, -1)
    S = np.empty(0, dtype=np.int64)
    C = np.empty(0)
    out: List[np.ndarray] = [None] * L
    for i in order:
        ids_list, costs_list = [], []
        if S.size:
            # moves: one graph step + emission check (M) and stay at +1
            # (I / read insertion).  No explicit deletion move: around a
            # deletion the OPPOSITE pass supplies the skipped node at the
            # emitting position (its chain crosses the junction from the
            # other side), so the union covers the constrained DP's
            # within-step D recursion — and dropping the succ^2 fan is a
            # ~4x cut in per-position work.
            base = C * CHAIN_DECAY
            f1 = step[S].ravel()
            c1 = np.repeat(base, 4)
            pen1 = np.where(emis[np.maximum(f1, 0)] == rb[i], 0.0, 1.0)
            ids_list.append(f1)
            costs_list.append(c1 + pen1)
            ids_list.append(S)
            costs_list.append(base + CHAIN_STAY)
        h = hits.get(i)
        if h is not None:
            ids_list.append(h)
            costs_list.append(np.full(h.size, CHAIN_HIT_COST))
        if ids_list:
            S, C = _combine(ids_list, costs_list, CHAIN_CMAX, PASS_WIDTH)
        else:
            S, C = S[:0], C[:0]
        out[i] = (S, C)
    return out


def _backfill(idx: SeedIndex, out: List[np.ndarray]) -> List[np.ndarray]:
    """Backfill remaining empty rows by plain graph walks from their
    neighbors (keeping the previous set for insertions).  An empty row
    forces a position-priced begin re-entry, and an empty LAST row makes
    the read score exactly -inf (the end state reads only M/I/D —
    ref forward.rs:554), which poisons every candidate's total into -inf
    (round-5: reads 52/61, late-read errors killed both passes' tails)."""
    L = len(out)
    for i in range(1, L):
        if out[i].size == 0 and out[i - 1].size:
            out[i] = np.unique(np.concatenate(
                [out[i - 1], idx.succ_edges(out[i - 1])]
            ))[:WIDTH_CAP]
    for i in range(L - 2, -1, -1):
        if out[i].size == 0 and out[i + 1].size:
            out[i] = np.unique(np.concatenate(
                [out[i + 1], idx.pred_edges(out[i + 1])]
            ))[:WIDTH_CAP]
    return out


def _read_hits(idx: SeedIndex, read: bytes):
    """Exact suffix-key hits per position: {pos: edge-id array}."""
    key_bytes = bytes(read)
    L = len(key_bytes)
    hits = {}
    for i in range(idx.s - 1, L):
        h = idx.lookup(key_bytes[i - idx.s + 1 : i + 1])
        if h is not None:
            hits[i] = h
    return hits


def seed_read(idx: SeedIndex, read: bytes) -> List[np.ndarray]:
    """Per-position candidate edge sets for one read (pure-Python path;
    production uses :func:`seed_read_native` when the C++ kernel loads)."""
    rb = np.frombuffer(bytes(read), dtype=np.uint8)
    L = len(rb)
    empty = np.empty(0, dtype=np.int64)
    hits = _read_hits(idx, read)
    if not hits:
        return [empty] * L
    fwd = _scored_pass(idx, rb, hits, forward=True)
    bwd = _scored_pass(idx, rb, hits, forward=False)
    out = []
    for (fs, fc), (bs, bc) in zip(fwd, bwd):
        if fs.size and bs.size:
            u, _c = _combine([fs, bs], [fc, bc], np.inf, UNION_WIDTH)
            out.append(u)
        else:
            out.append((fs if fs.size else bs)[:UNION_WIDTH])
    return _backfill(idx, out)


# -- native kernel (csrc/host/seedchain.cpp) -----------------------------------

_SEED_LIB = None
_SEED_LIB_TRIED = False


def _seed_lib():
    """ctypes handle to the native chain-DP kernel (csrc/host/seedchain.cpp),
    built with g++ into the port's build directory on first use.  DBGPHMM_NATIVE_SEED=0
    forces the pure-Python path."""
    global _SEED_LIB, _SEED_LIB_TRIED
    if _SEED_LIB_TRIED:
        return _SEED_LIB
    _SEED_LIB_TRIED = True
    import os

    if os.environ.get("DBGPHMM_NATIVE_SEED", "1") == "0":
        return None
    import ctypes
    import sys

    from ..ops import _build

    try:
        lib = ctypes.CDLL(str(_build.host_so("seedchain")))
        lib.dbg_seed_chain_union.restype = ctypes.c_int
        lib.dbg_seed_chain_union.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint8),
            ctypes.c_int32, np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),
        ]
        _SEED_LIB = lib
    except Exception as e:  # pragma: no cover - toolchain issues
        print(f"[seed.native] build/load failed, using Python chain DP: {e}",
              file=sys.stderr)
        _SEED_LIB = None
    return _SEED_LIB


def seed_read_native(idx: SeedIndex, read: bytes) -> Optional[List[np.ndarray]]:
    """Native two-pass chain DP + union; None if the kernel is unavailable."""
    lib = _seed_lib()
    if lib is None:
        return None
    rb = np.frombuffer(bytes(read), dtype=np.uint8)
    L = len(rb)
    empty = np.empty(0, dtype=np.int64)
    hits = _read_hits(idx, read)
    if not hits:
        return [empty] * L
    hit_off = np.zeros(L + 1, dtype=np.int64)
    for i, h in hits.items():
        hit_off[i + 1] = h.size
    np.cumsum(hit_off, out=hit_off)
    hit_ids = np.concatenate([hits[i] for i in sorted(hits)]).astype(np.int64)
    emis = np.ascontiguousarray(idx.keys[:, -1])
    succ = np.ascontiguousarray(idx._succ_pad)
    pred = np.ascontiguousarray(idx._pred_pad)
    out_ids = np.empty((L, UNION_WIDTH), dtype=np.int64)
    lib.dbg_seed_chain_union(
        idx.n_edges, succ, pred, emis, L, rb, hit_ids, hit_off,
        CHAIN_DECAY, CHAIN_STAY, CHAIN_HIT_COST, CHAIN_CMAX,
        PASS_WIDTH, UNION_WIDTH, out_ids,
    )
    out = [row[row >= 0] for row in out_ids]
    return _backfill(idx, out)


def seed_mappings_arrays(dbg, reads, s: int = SEED_S,
                         verbose: bool = False) -> List[np.ndarray]:
    """Seeded candidate arrays per read ([L, W] int32, -1 pad) — the hint
    input to ``generate_mappings(hint=...)``/``mappings_refine``."""
    import time

    t0 = time.time()
    idx = SeedIndex(dbg, s)
    arrs = []
    n_hit = n_pos = 0
    widths = []
    use_native = _seed_lib() is not None
    for r in reads:
        rb = bytes(r)
        sets = seed_read_native(idx, rb) if use_native else seed_read(idx, rb)
        W = max(1, max((len(x) for x in sets), default=1))
        a = np.full((len(rb), W), -1, dtype=np.int32)
        for i, x in enumerate(sets):
            a[i, : len(x)] = x
        arrs.append(a)
        n_pos += len(rb)
        n_hit += sum(1 for x in sets if len(x) > 0)
        widths.append(W)
    if verbose:
        print(f"[seed] {len(arrs)} reads seeded in {time.time()-t0:.1f}s "
              f"(cover {n_hit}/{n_pos} = {n_hit/max(1,n_pos):.4f}, "
              f"max width median {int(np.median(widths))} "
              f"max {max(widths, default=0)})")
    return arrs
