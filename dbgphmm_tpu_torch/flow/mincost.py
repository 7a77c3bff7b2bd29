"""Convex-cost integer min-cost circulation.

Equivalent of rustflow's ``min_cost_flow_convex_fast`` (ref: call sites
src/multi_dbg/draft.rs:297, src/hashdbg.rs:561).  The network is a
:class:`~dbgphmm_tpu.graph.digraph.DiGraph` whose edge weights are
:class:`FlowEdge` (integer ``demand <= f <= capacity`` bounds and a convex
cost function of the integer flow).

Algorithm (standard convex-cost circulation, built for the problem sizes the
assembler produces -- compact DBGs with 10^2..10^5 edges):

1. start from the pointwise minimizer ``f[e] = argmin_c cost_e(c)`` clamped to
   ``[demand, capacity]`` (integer convexity makes this a local scan),
2. repair node imbalances by pushing unit flow along Bellman-Ford shortest
   paths of *marginal* cost in the residual network (marginals may be
   negative, so Dijkstra is not applicable),
3. cancel negative marginal-cost cycles until none remain.  For separable
   convex integer costs, absence of negative residual cycles certifies global
   optimality.

Returns None when no feasible circulation exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from ..graph.digraph import DiGraph

INF = float("inf")


@dataclass
class FlowEdge:
    """Flow bounds + cost of one edge (rustflow ``FlowEdgeBase``/``ConvexCost``)."""

    demand: int = 0
    capacity: int = 0
    cost: float = 0.0  # linear cost coefficient (cost per unit)
    convex_cost: Optional[Callable[[int], float]] = None

    def cost_at(self, f: int) -> float:
        if self.convex_cost is not None:
            return self.convex_cost(f)
        return self.cost * f


def _argmin_convex(edge: FlowEdge) -> int:
    """Integer argmin of a convex function on [demand, capacity] via marginal
    sign scan (binary search on the discrete derivative)."""
    lo, hi = edge.demand, edge.capacity
    if lo >= hi:
        return lo
    if edge.convex_cost is None:
        # linear: minimize at lo if cost >= 0 else hi
        return lo if edge.cost >= 0 else hi
    # find smallest c in [lo, hi) with cost(c+1) - cost(c) >= 0
    c = edge.cost_at
    a, b = lo, hi
    while a < b:
        m = (a + b) // 2
        if c(m + 1) - c(m) >= 0:
            b = m
        else:
            a = m + 1
    return a


def _marginal_up(edge: FlowEdge, f: int) -> float:
    return edge.cost_at(f + 1) - edge.cost_at(f)


def _marginal_down(edge: FlowEdge, f: int) -> float:
    return edge.cost_at(f - 1) - edge.cost_at(f)


class _Residual:
    """Marginal-cost residual network over the flow state."""

    def __init__(self, net: DiGraph, flow: List[int]):
        self.net = net
        self.flow = flow

    def arcs_from(self, v: int):
        """Yield (to, orig_edge, +1/-1, marginal_cost) residual arcs at v."""
        net, flow = self.net, self.flow
        for e in net._out[v]:
            w: FlowEdge = net.edge_weights[e]
            f = flow[e]
            if f < w.capacity:
                yield net.edge_targets[e], e, +1, _marginal_up(w, f)
        for e in net._in[v]:
            w = net.edge_weights[e]
            f = flow[e]
            if f > w.demand:
                yield net.edge_sources[e], e, -1, _marginal_down(w, f)


def _bellman_ford_path(
    res: _Residual, sources: Sequence[int], targets: set, n: int
) -> Optional[List[Tuple[int, int]]]:
    """Shortest path (by marginal cost, possibly negative) from any source to
    any target. Returns [(orig_edge, delta)] or None."""
    dist = [INF] * n
    pred: List[Optional[Tuple[int, int, int]]] = [None] * n  # (from, edge, delta)
    for s in sources:
        dist[s] = 0.0
    for _round in range(n):
        changed = False
        for v in range(n):
            if dist[v] == INF:
                continue
            dv = dist[v]
            for to, e, delta, cost in res.arcs_from(v):
                nd = dv + cost
                if nd < dist[to] - 1e-12:
                    dist[to] = nd
                    pred[to] = (v, e, delta)
                    changed = True
        if not changed:
            break
    best_t, best_d = None, INF
    for t in targets:
        if dist[t] < best_d:
            best_t, best_d = t, dist[t]
    if best_t is None:
        return None
    path = []
    v = best_t
    src_set = set(sources)
    while pred[v] is not None:
        u, e, delta = pred[v]
        path.append((e, delta))
        v = u
        if v in src_set and pred[v] is None:
            break
    path.reverse()
    return path


def _find_negative_cycle(res: _Residual, n: int) -> Optional[List[Tuple[int, int]]]:
    """Bellman-Ford negative cycle detection on the residual network.
    Returns [(orig_edge, delta)] or None."""
    dist = [0.0] * n
    pred: List[Optional[Tuple[int, int, int]]] = [None] * n
    x = -1
    for _round in range(n):
        x = -1
        for v in range(n):
            dv = dist[v]
            for to, e, delta, cost in res.arcs_from(v):
                if dv + cost < dist[to] - 1e-9:
                    dist[to] = dv + cost
                    pred[to] = (v, e, delta)
                    x = to
        if x == -1:
            return None
    # walk back n steps to land inside the cycle
    v = x
    for _ in range(n):
        v = pred[v][0]
    cycle = []
    u = v
    while True:
        pv, e, delta = pred[u]
        cycle.append((e, delta))
        u = pv
        if u == v:
            break
    cycle.reverse()
    return cycle


def min_cost_flow_convex(net: DiGraph) -> Optional[List[int]]:
    """Minimum-cost integer circulation on ``net`` (edges: :class:`FlowEdge`).

    Returns the optimal flow per edge, or None if infeasible.
    """
    n = net.n_nodes()
    m = net.n_edges()
    for _e, w in enumerate(net.edge_weights):
        if w.demand > w.capacity:
            return None

    # (1) pointwise init
    flow = [_argmin_convex(w) for w in net.edge_weights]
    res = _Residual(net, flow)

    # (2) cancel negative cycles FIRST so Bellman-Ford predecessor chains in
    # the path-repair phase form a tree (SSP with unit pushes then preserves
    # the no-negative-cycle invariant for separable convex integer costs)
    for _guard in range(1000000):
        cycle = _find_negative_cycle(res, n)
        if cycle is None:
            break
        for e, delta in cycle:
            flow[e] += delta

    # (3) fix imbalances by unit pushes along min-marginal-cost paths
    ex = [0] * n
    for e in range(m):
        f = flow[e]
        ex[net.edge_targets[e]] += f
        ex[net.edge_sources[e]] -= f

    while True:
        sources = [v for v in range(n) if ex[v] > 0]
        targets = {v for v in range(n) if ex[v] < 0}
        if not sources:
            break
        path = _bellman_ford_path(res, sources, targets, n)
        if path is None:
            return None  # infeasible
        # determine endpoints to update excess
        first_e, first_d = path[0]
        start = (
            net.edge_sources[first_e] if first_d > 0 else net.edge_targets[first_e]
        )
        last_e, last_d = path[-1]
        end = net.edge_targets[last_e] if last_d > 0 else net.edge_sources[last_e]
        for e, delta in path:
            flow[e] += delta
        ex[start] -= 1
        ex[end] += 1

    # (4) safety: re-check optimality (new negative cycles should not appear,
    # but unit pushes on ties can leave one; cancel if found)
    for _guard in range(100000):
        cycle = _find_negative_cycle(res, n)
        if cycle is None:
            break
        for e, delta in cycle:
            flow[e] += delta
    return flow
