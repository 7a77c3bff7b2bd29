"""Euler circuit counting (BEST theorem) and extraction (Hierholzer).

Counting follows the reference exactly (ref: src/graph/euler.rs:22-128):
log #EC = log det(L + e0 e0^T) + sum_v log (deg_out(v) - 1)! - sum_e log c(e)!
computed per strongly-connected component, where the graph is a multigraph
given as (edge -> multiplicity c(e)) on a DiGraph.

The log-determinant is the reference's only BLAS call (LAPACK sln_det); here it
is ``numpy.linalg.slogdet`` — on-device ``jnp.linalg.slogdet`` is used by the
posterior scorer when the compact graph is large (see multi_dbg.posterior).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..prob import NEG_INF, log_factorial
from .digraph import DiGraph


def _euler_count_connected(
    node_ids: List[int], edges: List[Tuple[int, int, int]]
) -> float:
    """Count on one SCC. ``edges`` = (source, target, copy_num) with both
    endpoints in node_ids and copy_num > 0."""
    n = len(node_ids)
    if n == 0:
        return 0.0
    rank = {v: i for i, v in enumerate(node_ids)}
    lap = np.zeros((n, n), dtype=np.float64)
    out_deg = np.zeros(n, dtype=np.int64)
    for s, t, c in edges:
        i, j = rank[s], rank[t]
        out_deg[i] += c
        lap[i, j] -= c
    lap[np.arange(n), np.arange(n)] += out_deg
    lap[0, 0] += 1.0
    sign, ln = np.linalg.slogdet(lap)
    # reference behavior (euler.rs:62-66): count = sign * ln, 0 edges -> -inf
    count = 0.0 if ln == NEG_INF else float(sign * ln)
    for i in range(n):
        if out_deg[i] > 0:
            count += log_factorial(int(out_deg[i]) - 1)
    for _s, _t, c in edges:
        count -= log_factorial(c)
    return count


def euler_circuit_count(
    graph: DiGraph, copy_nums: Optional[List[int]] = None, allow_multiple_component: bool = True
) -> float:
    """Log number of Eulerian circuits of the multigraph whose edge ``e`` has
    multiplicity ``copy_nums[e]`` (default: edge weight as int).

    With ``allow_multiple_component`` the result is the product over SCCs
    (ref: euler.rs:92-128).
    """
    if copy_nums is None:
        copy_nums = [int(w) for w in graph.edge_weights]

    # keep only positive edges / nodes with outgoing edges
    pos_edges = [
        (graph.edge_sources[e], graph.edge_targets[e], copy_nums[e])
        for e in range(graph.n_edges())
        if copy_nums[e] > 0
    ]
    live = DiGraph()
    node_of: Dict[int, int] = {}
    back: List[int] = []
    for s, t, c in pos_edges:
        for v in (s, t):
            if v not in node_of:
                node_of[v] = live.add_node(None)
                back.append(v)
        live.add_edge(node_of[s], node_of[t], c)
    # drop nodes without outgoing edges from SCC consideration: Tarjan puts
    # them in singleton comps whose count contribution is 0 edges -> skipped
    if live.n_nodes() == 0:
        return NEG_INF

    sccs = live.strongly_connected_components()
    if not allow_multiple_component and len(sccs) > 1:
        return NEG_INF

    total = 0.0
    for comp in sccs:
        comp_set = set(comp)
        comp_edges = [
            (live.edge_sources[e], live.edge_targets[e], live.edge_weights[e])
            for e in range(live.n_edges())
            if live.edge_sources[e] in comp_set and live.edge_targets[e] in comp_set
        ]
        if not comp_edges:
            continue
        total += _euler_count_connected(sorted(comp_set), comp_edges)
    return total


def euler_circuit(
    graph: DiGraph,
    copy_nums: List[int],
    start: int,
    child_priority: Optional[Dict[int, int]] = None,
) -> List[int]:
    """Extract one Eulerian circuit as an edge list via Hierholzer
    (ref: euler.rs:133-240; deterministic child order via ``child_priority``,
    cf. multi_dbg.rs:594 sorting children by base).

    Each edge ``e`` is traversed exactly ``copy_nums[e]`` times.
    """
    remaining = list(copy_nums)
    # per node: out-edge indices in priority order
    order: Dict[int, List[int]] = {}
    for v in range(graph.n_nodes()):
        es = graph.out_edges(v)
        if child_priority is not None:
            es = sorted(es, key=lambda e: child_priority.get(e, e))
        order[v] = es

    def next_edge(v: int) -> Optional[int]:
        for e in order[v]:
            if remaining[e] > 0:
                return e
        return None

    # Hierholzer: walk until stuck, then splice sub-circuits
    circuit: List[int] = []
    stack_nodes = [start]
    stack_edges: List[int] = []
    while stack_nodes:
        v = stack_nodes[-1]
        e = next_edge(v)
        if e is not None:
            remaining[e] -= 1
            stack_edges.append(e)
            stack_nodes.append(graph.edge_targets[e])
        else:
            stack_nodes.pop()
            if stack_edges:
                circuit.append(stack_edges.pop())
    circuit.reverse()
    assert all(r == 0 for r in remaining), "graph has no Eulerian circuit covering all copies"
    return circuit


class EulerCache:
    """Incremental BEST-theorem counts for copy-num assignments near a base
    assignment (ref: euler.rs:22-128; posterior scoring calls one count per
    CANDIDATE, posterior.rs:504-515).

    The dominant cost of :func:`euler_circuit_count` is the O(n^3) log-det
    of the copy-weighted Laplacian (n = live compact nodes; ~5.3k on the
    KIR-class graph -> ~4s per candidate on this host).  Candidates are
    neighbors of the base flow — they differ by one +-1 residual cycle — so
    their matrix differs from the base's by entries confined to the cycle's
    rows.  This cache LU-factors the base matrix ONCE and evaluates each
    candidate via the matrix determinant lemma:

        det(A + E_R W) = det(A) * det(I_r + W A^-1 E_R)

    with r = touched rows (~cycle length).  The per-SCC block structure is
    folded into ONE block-diagonal matrix over all live nodes (flow
    consistency forbids positive edges between SCCs) with the +1 tweak at
    each SCC's first node; SCC-structure changes between base and candidate
    become +-1 tweak deltas in W.  EXACT — candidates whose live node set
    differs from the base's fall back to the full computation.
    """

    def __init__(self, graph: DiGraph, base_copy_nums, strict: bool = True):
        import scipy.linalg as sla

        self.strict = strict
        self.graph = graph
        self.src = np.asarray(graph.edge_sources, dtype=np.int64)
        self.dst = np.asarray(graph.edge_targets, dtype=np.int64)
        self.base = np.asarray(base_copy_nums, dtype=np.int64)
        self.ok = False
        self.n = graph.n_nodes()
        if self.n == 0 or self.src.size == 0:
            return
        base_live = self._live_mask(self.base)
        if not base_live.any():
            return
        self.base_live = base_live
        firsts = self._scc_firsts(self.base)
        if firsts is None:
            return
        self.base_firsts = firsts
        m0 = self._matrix(self.base, firsts, base_live)
        try:
            lu = sla.lu_factor(m0)
        except Exception:
            return
        diag = np.diag(lu[0])
        if np.any(diag == 0.0):
            return
        piv = lu[1]
        parity = np.count_nonzero(piv != np.arange(piv.size)) % 2
        self.sign0 = (-1.0) ** parity * np.prod(np.sign(diag))
        self.logdet0 = float(np.sum(np.log(np.abs(diag))))
        if self.sign0 != 1.0:
            # negative/zero determinant: the per-SCC sign*ln sum of the
            # reference quirk is not reproducible from the global product -
            # serve everything through the full fallback
            return
        # full inverse ONCE: per-candidate A^-1 E_R becomes a column slice
        # instead of an O(n^2 r) lu_solve (round 5: the solve + the
        # live-set-change fallbacks made Euler counts the DOMINANT stage
        # cost - 170s vs 82s likelihood at n4 k=47)
        self.inv = sla.lu_solve(lu, np.eye(self.n))
        self.ok = True

    # -- helpers --------------------------------------------------------------

    def _live_mask(self, cn) -> np.ndarray:
        pos = cn > 0
        m = np.zeros(self.n, dtype=bool)
        m[self.src[pos]] = True
        m[self.dst[pos]] = True
        return m

    def _scc_firsts(self, cn) -> Optional[np.ndarray]:
        """Minimal node id of each LIVE SCC of the positive subgraph, or
        None when a positive edge crosses two SCCs (a flow-inconsistent
        candidate; the block-determinant form would be wrong)."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components

        pos = cn > 0
        s, t = self.src[pos], self.dst[pos]
        adj = sp.csr_matrix(
            (np.ones(len(s)), (s, t)), shape=(self.n, self.n)
        )
        n_comp, labels = connected_components(
            adj, directed=True, connection="strong"
        )
        if np.any(labels[s] != labels[t]):
            return None
        live_lab = np.zeros(n_comp, dtype=bool)
        live_lab[labels[s]] = True
        live_lab[labels[t]] = True
        firsts = np.full(n_comp, self.n, dtype=np.int64)
        np.minimum.at(firsts, labels, np.arange(self.n))
        return np.sort(firsts[live_lab])

    def _matrix(self, cn, firsts, live) -> np.ndarray:
        """Copy-weighted Laplacian over ALL nodes, with identity rows for
        dead nodes (their block contributes det = 1, so the determinant
        equals the live submatrix's - no live-set-dependent shape)."""
        n = self.n
        m = np.zeros((n, n), dtype=np.float64)
        pos = cn > 0
        s, t = self.src[pos], self.dst[pos]
        c = cn[pos].astype(np.float64)
        np.add.at(m, (s, s), c)  # out-degree on the diagonal
        np.subtract.at(m, (s, t), c)
        m[firsts, firsts] += 1.0
        dead = np.flatnonzero(~live)
        m[dead, dead] += 1.0
        return m

    def _scalar_terms(self, cn) -> float:
        from scipy.special import gammaln

        pos = cn > 0
        out_deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(out_deg, self.src[pos], cn[pos])
        tot = float(np.sum(gammaln(out_deg[out_deg > 0])))  # log (d-1)!
        tot -= float(np.sum(gammaln(cn[pos] + 1.0)))  # -log c!
        return tot

    # -- api ------------------------------------------------------------------

    def count(self, copy_nums, max_rank: int = 256) -> float:
        cn = np.asarray(copy_nums, dtype=np.int64)
        fallback = lambda: euler_circuit_count(
            self.graph, list(copy_nums),
            allow_multiple_component=not self.strict,
        )
        if not self.ok:
            return fallback()
        firsts = self._scc_firsts(cn)
        if firsts is None:
            return fallback()
        if self.strict and firsts.size > 1:
            # reference semantics (multi_dbg.rs:836): several SCCs -> no
            # Eulerian circuit
            return NEG_INF
        live = self._live_mask(cn)

        # delta entries: rows confined to sources of changed edges, tweak
        # positions, and nodes whose liveness flips (identity row added or
        # removed) - ALL row-confined, so the determinant lemma applies
        # even when the candidate resurrects or kills nodes
        changed = np.nonzero(cn != self.base)[0]
        rows = set()
        entries = {}

        def add(i, j, v):
            if v:
                entries[(i, j)] = entries.get((i, j), 0.0) + v
                rows.add(i)

        for e in changed:
            d = float(cn[e] - self.base[e])
            i, j = int(self.src[e]), int(self.dst[e])
            add(i, i, d)
            add(i, j, -d)
        for f in np.setdiff1d(firsts, self.base_firsts):
            add(int(f), int(f), 1.0)
        for f in np.setdiff1d(self.base_firsts, firsts):
            add(int(f), int(f), -1.0)
        for v in np.flatnonzero(live & ~self.base_live):
            add(int(v), int(v), -1.0)  # was identity, now real
        for v in np.flatnonzero(self.base_live & ~live):
            add(int(v), int(v), 1.0)  # now dead: make it an identity row

        r = len(rows)
        if r == 0:
            sign, logdet = self.sign0, self.logdet0
        elif r > max_rank:
            return fallback()
        else:
            rlist = sorted(rows)
            ridx = {i: a for a, i in enumerate(rlist)}
            w = np.zeros((r, self.n), dtype=np.float64)
            for (i, j), v in entries.items():
                w[ridx[i], j] += v
            x = self.inv[:, rlist]  # A^-1 E_R (column slice of the inverse)
            s_small = np.eye(r) + w @ x
            sgn, ld = np.linalg.slogdet(s_small)
            if ld == NEG_INF or sgn != 1.0:
                return fallback()
            sign, logdet = self.sign0 * sgn, self.logdet0 + ld

        count = float(sign * logdet)
        return count + self._scalar_terms(cn)
