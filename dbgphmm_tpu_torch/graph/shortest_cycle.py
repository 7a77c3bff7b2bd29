"""Shortest cycle through a given edge.

Finds the shortest cycle containing ``edge_with = (v -> w)`` while optionally
forbidding the reverse edge ``edge_without = (w -> v)`` from being used to
close the cycle (ref: src/graph/shortest_cycle.rs:14-44; the reference uses
unit-cost A* — plain BFS is equivalent and simpler).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

from .digraph import DiGraph


def shortest_cycle(
    graph: DiGraph,
    edge_with: int,
    edge_without: Optional[int] = None,
) -> Optional[List[int]]:
    """Return node list of the shortest path w -> v closing the cycle through
    ``edge_with = (v, w)``, or None if no cycle exists.

    The returned list starts at ``w`` and ends at ``v`` (matching the
    reference's astar path convention).
    """
    v, w = graph.edge_endpoints(edge_with)
    if edge_without is not None:
        w2, v2 = graph.edge_endpoints(edge_without)
        if (w2, v2) != (w, v):
            raise ValueError("edge_without must be the reverse of edge_with")

    # BFS from w to v, not traversing edge_without
    prev = {w: None}
    queue = deque([w])
    while queue:
        u = queue.popleft()
        if u == v:
            path = []
            while u is not None:
                path.append(u)
                u = prev[u]
            return path[::-1]
        for e in graph.out_edges(u):
            if e == edge_without:
                continue
            t = graph.edge_targets[e]
            if t not in prev:
                prev[t] = u
                queue.append(t)
    return None
