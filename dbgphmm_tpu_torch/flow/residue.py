"""Residual graph of a flow + neighbor-flow enumeration.

Equivalent of rustflow's ``residue`` module as consumed by the reference
(ref: src/multi_dbg/neighbors.rs:22-26,347-478):

* :func:`flow_to_residue_convex` -- residual DiGraph with Up/Down arcs
  weighted by the marginal convex cost of a +-1 change,
* :func:`residue_graph_cycle_to_flow` -- apply a residual cycle to a flow,
* :func:`enumerate_neighboring_flows` -- all edge-simple residual cycles with
  bounded size and bounded Up/Down flips -> neighbor flows,
* :func:`find_neighboring_flow_by_edge_change` -- min-weight cycle forcing a
  single +-1 change on a chosen edge,
* ``"e5+e2-"`` update-cycle string round-trip (ref: neighbors.rs:55-187).
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..graph.digraph import DiGraph
from .mincost import FlowEdge, _marginal_down, _marginal_up

UP = "+"
DOWN = "-"

UpdateCycle = List[Tuple[int, str]]  # [(original edge index, UP/DOWN)]


@dataclass
class ResidueEdge:
    """Weight of a residual arc."""

    target: int  # original edge index
    direction: str  # UP / DOWN
    weight: float  # marginal cost of the +-1 move


def flow_to_residue_convex(net: DiGraph, flow: List[int]) -> DiGraph:
    """Build the residual graph: same nodes as ``net``; for each edge
    e=(v,w): Up arc v->w if f<capacity, Down arc w->v if f>demand."""
    rg = DiGraph()
    for _v, w in net.nodes():
        rg.add_node(w)
    for e, s, t, fe in net.edges():
        f = flow[e]
        if f < fe.capacity:
            rg.add_edge(s, t, ResidueEdge(e, UP, _marginal_up(fe, f)))
        if f > fe.demand:
            rg.add_edge(t, s, ResidueEdge(e, DOWN, _marginal_down(fe, f)))
    return rg


def residue_graph_cycle_to_flow(
    flow: List[int], rg: DiGraph, cycle: List[int]
) -> Tuple[List[int], UpdateCycle]:
    """Apply a residual cycle (list of rg edge indices) to the flow."""
    new_flow = list(flow)
    update: UpdateCycle = []
    for re_idx in cycle:
        r: ResidueEdge = rg.edge(re_idx)
        new_flow[r.target] += 1 if r.direction == UP else -1
        update.append((r.target, r.direction))
    return new_flow, update


def is_edge_simple(rg: DiGraph, cycle: List[int]) -> bool:
    """No original edge appears twice in the cycle (petgraph_algos
    ``is_edge_simple`` as used at neighbors.rs:17,384)."""
    targets = [rg.edge(e).target for e in cycle]
    return len(targets) == len(set(targets))


def _count_flips(dirs: List[str]) -> int:
    """Number of Up/Down switches along the cyclic direction sequence."""
    if not dirs:
        return 0
    flips = sum(1 for i in range(len(dirs) - 1) if dirs[i] != dirs[i + 1])
    if dirs[-1] != dirs[0]:
        flips += 1
    return flips


def enumerate_neighboring_flows(
    net: DiGraph,
    flow: List[int],
    max_cycle_size: Optional[int] = None,
    max_flip: Optional[int] = None,
    max_results: int = 100000,
) -> List[Tuple[List[int], UpdateCycle]]:
    """Enumerate neighbor flows reachable by one edge-simple residual cycle
    with at most ``max_cycle_size`` arcs and ``max_flip`` direction switches.

    Deduplicates by resulting flow vector.  DFS with canonical-start pruning:
    each cycle is discovered exactly once, started at its minimum rg-arc index.
    """
    rg = flow_to_residue_convex(net, flow)
    n_rg = rg.n_edges()
    results: List[Tuple[List[int], UpdateCycle]] = []
    seen_flows = set()

    max_size = max_cycle_size if max_cycle_size is not None else 10

    for e0 in range(n_rg):
        start_node = rg.edge_sources[e0]
        # DFS stack: (current node, path of rg edges, used original edges)
        r0 = rg.edge(e0)
        stack = [(rg.edge_targets[e0], [e0], {r0.target})]
        while stack:
            node, path, used = stack.pop()
            if node == start_node:
                dirs = [rg.edge(e).direction for e in path]
                if max_flip is None or _count_flips(dirs) <= max_flip:
                    new_flow, update = residue_graph_cycle_to_flow(flow, rg, path)
                    key = tuple(new_flow)
                    if key not in seen_flows:
                        seen_flows.add(key)
                        results.append((new_flow, update))
                        if len(results) >= max_results:
                            return results
                continue
            if len(path) >= max_size:
                continue
            for e, w, r in rg.childs(node):
                # canonical start: e0 is the minimum arc index in the cycle
                if e <= e0:
                    continue
                if r.target in used:
                    continue
                stack.append((w, path + [e], used | {r.target}))
    return results


def find_neighboring_flow_by_edge_change(
    net: DiGraph,
    flow: List[int],
    edge: int,
    direction: str,
    weight_fn: Optional[Callable[[int], int]] = None,
) -> Optional[Tuple[List[int], UpdateCycle]]:
    """Min-weight residual cycle that forces a +-1 change on ``edge``
    (ref: neighbors.rs:440-449 for the long-neighbor search).

    ``weight_fn(original_edge_index) -> int`` weights the *other* arcs of the
    cycle (the forced arc itself costs 0).
    """
    rg = flow_to_residue_convex(net, flow)
    forced = None
    for e, _s, _t, r in rg.edges():
        if r.target == edge and r.direction == direction:
            forced = e
            break
    if forced is None:
        return None
    v, w = rg.edge_endpoints(forced)

    if weight_fn is None:
        cost = lambda e: 1
    else:
        cost = lambda e: weight_fn(rg.edge(e).target)

    # Dijkstra w -> v avoiding reuse of the forced original edge
    from ..graph.k_shortest import dijkstra_path

    banned = {
        e for e, _s, _t, r in rg.edges() if r.target == edge
    }
    res = dijkstra_path(rg, w, v, cost, removed_edges=banned)
    if res is None:
        return None
    _, path = res
    cycle = [forced] + path
    if not is_edge_simple(rg, cycle):
        return None
    new_flow, update = residue_graph_cycle_to_flow(flow, rg, cycle)
    return new_flow, update


# -- UpdateCycle string round-trip (ref: neighbors.rs:55-187) -----------------


def update_cycle_to_str(cycle: UpdateCycle) -> str:
    return "".join(f"e{e}{d}" for e, d in cycle)


def update_cycle_from_str(s: str) -> UpdateCycle:
    out: UpdateCycle = []
    for m in re.finditer(r"e(\d+)([+-])", s):
        out.append((int(m.group(1)), m.group(2)))
    return out
