"""Graph edit utilities (ref: src/graph/utils.rs).

Edge purging with index remapping is provided by
:meth:`dbgphmm_tpu.graph.digraph.DiGraph.remove_edges` (functional, monotone
maps) instead of the reference's swap-remove ``EdgeMap`` tracking.
"""

from __future__ import annotations

from typing import List, Optional

from .digraph import DiGraph


def bridge_edges(graph: DiGraph) -> List[int]:
    """Edges whose endpoints lie in different strongly connected components
    (ref: graph/utils.rs:244-272).  Such edges can never appear on an Eulerian
    circuit and are purged together with 0-copy edges."""
    comps = graph.strongly_connected_components()
    comp_id = [0] * graph.n_nodes()
    for cid, comp in enumerate(comps):
        for v in comp:
            comp_id[v] = cid
    return [
        e
        for e in range(graph.n_edges())
        if comp_id[graph.edge_sources[e]] != comp_id[graph.edge_targets[e]]
    ]


def split_node(graph: DiGraph, node: int, edge_weight: Optional[object]) -> DiGraph:
    """Split ``node`` into node_in -> node_out (ref: graph/utils.rs:301).

    In-edges re-target node_in, out-edges re-source node_out; if
    ``edge_weight`` is not None a bridging edge node_in->node_out is added,
    otherwise the halves stay disconnected.  Returns a NEW graph; edge order is
    preserved for original edges, the bridge edge is appended last.
    """
    g = DiGraph()
    for _v, w in graph.nodes():
        g.add_node(w)
    node_in = g.add_node(graph.node(node))
    node_out = g.add_node(graph.node(node))
    for _e, s, t, w in graph.edges():
        s2 = node_out if s == node else s
        t2 = node_in if t == node else t
        g.add_edge(s2, t2, w)
    if edge_weight is not None:
        g.add_edge(node_in, node_out, edge_weight)
    return g


def delete_isolated_nodes(graph: DiGraph) -> DiGraph:
    """Drop nodes with no in/out edges (ref: graph/utils.rs:232)."""
    g, _nm, _em = graph.remove_edges([])
    return g
