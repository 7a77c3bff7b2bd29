"""Plain arrays of a de Bruijn graph and the host arithmetic on them.

A :class:`Graph` holds the full graph (one edge per k-mer, its last base
and copy number; the terminal node joins the haplotypes' ends) and the
compact graph (maximal simple paths).  The functions below recompute, from
those arrays alone, what the benchmark compares the program's host layers
with: genome size and its prior, the log count of Euler circuits (BEST
theorem), and the k-mers of the k+1 extension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

NULL_BASE = ord("n")


@dataclass
class Graph:
    k: int
    n_nodes: int
    terminal: Optional[int]
    srcs: np.ndarray  # int64 [E] full edges
    tgts: np.ndarray
    bases: np.ndarray  # int64 [E] emission byte of each k-mer
    copy: np.ndarray  # int64 [E]
    c_srcs: np.ndarray  # int64 [Ec] compact edges
    c_tgts: np.ndarray
    c_nodes: int
    full_to_compact: np.ndarray  # int64 [E]

    @property
    def n_edges(self) -> int:
        return len(self.srcs)


def genome_size(g: Graph, compact_copy) -> int:
    """Sum over compact edges of copy number x non-null k-mers."""
    cn = np.asarray(compact_copy, dtype=np.int64)
    size = np.bincount(g.full_to_compact, weights=(g.bases != NULL_BASE),
                       minlength=len(g.c_srcs))
    return int(round(float(cn @ size)))


def normal_logpdf(x: float, mu: float, sigma: float, dtype=np.float64) -> float:
    x, mu, sigma = dtype(x), dtype(mu), dtype(sigma)
    z = (x - mu) / sigma
    return float(dtype(-0.5) * z * z - np.log(sigma)
                 - dtype(0.5) * np.log(dtype(2.0 * math.pi)))


def euler_log_count(g: Graph, compact_copy, dtype=np.float64) -> float:
    """log #Euler circuits of the compact multigraph with multiplicities
    ``compact_copy``; -inf when the positive part is not one strongly
    connected component (no single circuit).  Computed in ``dtype``."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.special import gammaln

    cn = np.asarray(compact_copy, dtype=np.int64)
    pos = cn > 0
    s, t, c = g.c_srcs[pos], g.c_tgts[pos], cn[pos]
    if not pos.any():
        return float("-inf")
    live = np.unique(np.concatenate([s, t]))
    rank = np.full(g.c_nodes, -1, dtype=np.int64)
    rank[live] = np.arange(len(live))
    si, ti, n = rank[s], rank[t], len(live)
    adj = csr_matrix((np.ones(len(si)), (si, ti)), shape=(n, n))
    n_comp, _ = connected_components(adj, directed=True, connection="strong")
    if n_comp > 1:
        return float("-inf")
    lap = np.zeros((n, n), dtype=dtype)
    np.add.at(lap, (si, si), c.astype(dtype))
    np.subtract.at(lap, (si, ti), c.astype(dtype))
    lap[0, 0] += dtype(1.0)
    sign, ln = np.linalg.slogdet(lap)
    out_deg = np.bincount(si, weights=c, minlength=n).astype(dtype)
    return float(sign * ln + gammaln(out_deg[out_deg > 0]).sum(dtype=dtype)
                 - gammaln(c.astype(dtype) + dtype(1.0)).sum(dtype=dtype))


def kmers(g: Graph) -> List[bytes]:
    """The k-mer of each full edge: its base after the k - 1 bases read
    backwards along in-edges (any in-edge: in a de Bruijn graph every
    backward path of length k - 1 spells the same bases; the terminal's
    margin edges spell 'n')."""
    first_in = np.full(g.n_nodes, -1, dtype=np.int64)
    order = np.argsort(g.tgts, kind="stable")
    first_in[g.tgts[order[::-1]]] = order[::-1]
    cols = [g.bases]
    cur = np.arange(g.n_edges)
    for _ in range(g.k - 1):
        src = g.srcs[cur]
        prev = first_in[src]
        ok = (prev >= 0) & (src != (g.terminal if g.terminal is not None else -1))
        cur = np.where(ok, prev, cur)
        cols.append(np.where(ok, g.bases[cur], NULL_BASE))
    mat = np.stack(cols[::-1], axis=1).astype(np.uint8)
    return [bytes(row) for row in mat]


def extension_faults(g_k: Graph, g_k1: Graph) -> int:
    """How far the k+1 graph departs from the k+1 extension of the k graph:
    (k+1)-mers of ``g_k1`` that are no join of two adjacent k-mers of
    ``g_k``, plus joins of adjacent positive-copy k-mers missing from
    ``g_k1`` (a purge removes zero-copy edges only)."""
    km = kmers(g_k)
    ends = {}
    for e, s in enumerate(km):
        ends.setdefault(s[1:], []).append(e)  # k-mers by their suffix
    joins_all, joins_pos = set(), set()
    for e2, s2 in enumerate(km):
        for e1 in ends.get(s2[:-1], []):
            j = km[e1] + s2[-1:]
            joins_all.add(j)
            if g_k.copy[e1] > 0 and g_k.copy[e2] > 0:
                joins_pos.add(j)
    got = set(kmers(g_k1))
    # edges touching the terminal spell null bases that no join carries
    plain = {s for s in got if NULL_BASE not in s}
    return (len(plain - joins_all)
            + len({j for j in joins_pos if NULL_BASE not in j} - got))
