"""Simple-path compaction (ref: src/graph/compact.rs:123-181).

Collapses chains of deg-(1,1) nodes into single compact edges.  Unlike the
reference's iterative remove-one-node-at-a-time (which churns petgraph
indices), we build the compact graph in one pass with deterministic ordering:

* compact nodes = non-internal original nodes, in original index order
* compact edges = maximal simple paths, discovered by scanning non-internal
  nodes in index order and their out-edges in insertion order; pure internal
  cycles become a self-loop on the smallest-index node of the cycle.

Edge weight of a compact edge is the ordered list ``[(orig_edge_idx, weight)]``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .digraph import DiGraph


def _is_internal(g: DiGraph, v: int, is_target: Callable[[object], bool]) -> bool:
    if not is_target(g.node(v)):
        return False
    if g.in_degree(v) != 1 or g.out_degree(v) != 1:
        return False
    # a single self-loop node is not internal
    return g.in_edges(v)[0] != g.out_edges(v)[0]


def compact_simple_paths(
    graph: DiGraph, is_target: Optional[Callable[[object], bool]] = None
) -> Tuple[DiGraph, Dict[int, int]]:
    """Compact simple paths.

    Returns ``(compact_graph, node_map)`` where ``node_map`` maps original
    node index -> compact node index (only for surviving nodes).

    ``is_target(node_weight)`` restricts which nodes may be collapsed
    (ref: compact_simple_paths_for_targeted_nodes, used to protect the
    terminal NNN node).
    """
    if is_target is None:
        is_target = lambda _w: True

    import numpy as np

    n = graph.n_nodes()
    g_in, g_out = graph._in, graph._out
    weights = graph.node_weights
    e_tgt = graph.edge_targets
    e_w = graph.edge_weights
    # vectorized degree test; per-node predicate + self-loop exception only
    # on the (1,1) candidates (this loop dominated k+1 extension time)
    in_deg = np.bincount(
        np.asarray(graph.edge_targets, dtype=np.int64), minlength=n
    )
    out_deg = np.bincount(
        np.asarray(graph.edge_sources, dtype=np.int64), minlength=n
    )
    internal = [False] * n
    for v in np.flatnonzero((in_deg == 1) & (out_deg == 1)):
        v = int(v)
        if is_target(weights[v]) and g_in[v][0] != g_out[v][0]:
            internal[v] = True

    out = DiGraph()
    node_map: Dict[int, int] = {}
    for v in range(n):
        if not internal[v]:
            node_map[v] = out.add_node(weights[v])

    visited_edge = [False] * graph.n_edges()

    # paths starting from non-internal nodes
    for v in range(n):
        if internal[v]:
            continue
        for e0 in g_out[v]:
            if visited_edge[e0]:
                continue
            path = [(e0, e_w[e0])]
            visited_edge[e0] = True
            w = e_tgt[e0]
            while internal[w]:
                e_next = g_out[w][0]
                path.append((e_next, e_w[e_next]))
                visited_edge[e_next] = True
                w = e_tgt[e_next]
            out.add_edge(node_map[v], node_map[w], path)

    # pure internal cycles
    for v in range(n):
        if not internal[v]:
            continue
        e0 = graph.out_edges(v)[0]
        if visited_edge[e0]:
            continue
        # walk the cycle, find the smallest node as representative
        cycle_nodes = [v]
        w = graph.edge_targets[e0]
        while w != v:
            cycle_nodes.append(w)
            w = graph.edge_targets[graph.out_edges(w)[0]]
        rep = min(cycle_nodes)
        node_map[rep] = out.add_node(graph.node(rep))
        # walk from rep
        path = []
        e = graph.out_edges(rep)[0]
        while True:
            path.append((e, graph.edge(e)))
            visited_edge[e] = True
            w = graph.edge_targets[e]
            if w == rep:
                break
            e = graph.out_edges(w)[0]
        out.add_edge(node_map[rep], node_map[rep], path)

    return out, node_map
