"""A lightweight directed multigraph with stable integer indices.

Replaces petgraph's ``DiGraph`` (the reference's universal container).  Unlike
petgraph, edge removal here is *functional*: :meth:`remove_edges` returns a new
graph plus old->new index maps, which removes the need for the reference's
``EdgeMap`` index-churn tracking (ref: src/graph/utils.rs:45-217).

Node and edge weights are arbitrary Python objects.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple


class DiGraph:
    __slots__ = ("node_weights", "edge_sources", "edge_targets", "edge_weights", "_out", "_in")

    def __init__(self):
        self.node_weights: List[Any] = []
        self.edge_sources: List[int] = []
        self.edge_targets: List[int] = []
        self.edge_weights: List[Any] = []
        self._out: List[List[int]] = []  # node -> out edge indices (insertion order)
        self._in: List[List[int]] = []  # node -> in edge indices

    # -- construction ---------------------------------------------------------

    def add_node(self, weight: Any = None) -> int:
        self.node_weights.append(weight)
        self._out.append([])
        self._in.append([])
        return len(self.node_weights) - 1

    def add_edge(self, source: int, target: int, weight: Any = None) -> int:
        e = len(self.edge_weights)
        self.edge_sources.append(source)
        self.edge_targets.append(target)
        self.edge_weights.append(weight)
        self._out[source].append(e)
        self._in[target].append(e)
        return e

    # -- basic accessors ------------------------------------------------------

    def n_nodes(self) -> int:
        return len(self.node_weights)

    def n_edges(self) -> int:
        return len(self.edge_weights)

    def node(self, v: int) -> Any:
        return self.node_weights[v]

    def edge(self, e: int) -> Any:
        return self.edge_weights[e]

    def edge_endpoints(self, e: int) -> Tuple[int, int]:
        return self.edge_sources[e], self.edge_targets[e]

    def nodes(self) -> Iterator[Tuple[int, Any]]:
        return enumerate(self.node_weights)

    def edges(self) -> Iterator[Tuple[int, int, int, Any]]:
        """Yield (edge_idx, source, target, weight)."""
        for e in range(len(self.edge_weights)):
            yield e, self.edge_sources[e], self.edge_targets[e], self.edge_weights[e]

    def childs(self, v: int) -> List[Tuple[int, int, Any]]:
        """Out-edges of v: [(edge_idx, child, weight)]."""
        return [(e, self.edge_targets[e], self.edge_weights[e]) for e in self._out[v]]

    def parents(self, v: int) -> List[Tuple[int, int, Any]]:
        """In-edges of v: [(edge_idx, parent, weight)]."""
        return [(e, self.edge_sources[e], self.edge_weights[e]) for e in self._in[v]]

    def out_edges(self, v: int) -> List[int]:
        return list(self._out[v])

    def in_edges(self, v: int) -> List[int]:
        return list(self._in[v])

    def out_degree(self, v: int) -> int:
        return len(self._out[v])

    def in_degree(self, v: int) -> int:
        return len(self._in[v])

    def find_edge(self, a: int, b: int) -> Optional[int]:
        for e in self._out[a]:
            if self.edge_targets[e] == b:
                return e
        return None

    def has_parallel_edge(self, e: int) -> bool:
        s, t = self.edge_endpoints(e)
        return sum(1 for x in self._out[s] if self.edge_targets[x] == t) > 1

    # -- transforms ------------------------------------------------------------

    def map(self, node_fn: Callable[[int, Any], Any], edge_fn: Callable[[int, Any], Any]) -> "DiGraph":
        """petgraph-style map over weights preserving structure."""
        g = DiGraph()
        for v, w in self.nodes():
            g.add_node(node_fn(v, w))
        for e, s, t, w in self.edges():
            g.add_edge(s, t, edge_fn(e, w))
        return g

    def remove_edges(self, edges_to_remove: Iterable[int]) -> Tuple["DiGraph", Dict[int, int], Dict[int, int]]:
        """Return (new graph, node_map old->new, edge_map old->new), dropping
        the given edges and any nodes that become isolated.

        Remaining nodes/edges keep their relative order, so index maps are
        monotone (unlike petgraph's swap-remove, ref: graph/utils.rs:219-242).
        """
        dead = set(edges_to_remove)
        keep_edges = [e for e in range(self.n_edges()) if e not in dead]
        used_nodes = set()
        for e in keep_edges:
            used_nodes.add(self.edge_sources[e])
            used_nodes.add(self.edge_targets[e])
        node_map: Dict[int, int] = {}
        g = DiGraph()
        for v in range(self.n_nodes()):
            if v in used_nodes:
                node_map[v] = g.add_node(self.node_weights[v])
        edge_map: Dict[int, int] = {}
        for e in keep_edges:
            edge_map[e] = g.add_edge(
                node_map[self.edge_sources[e]],
                node_map[self.edge_targets[e]],
                self.edge_weights[e],
            )
        return g, node_map, edge_map

    def copy(self) -> "DiGraph":
        return self.map(lambda _v, w: w, lambda _e, w: w)

    # -- connectivity ----------------------------------------------------------

    def strongly_connected_components(self) -> List[List[int]]:
        """Tarjan SCC (iterative). Components in reverse topological order."""
        n = self.n_nodes()
        index = [-1] * n
        low = [0] * n
        on_stack = [False] * n
        stack: List[int] = []
        comps: List[List[int]] = []
        counter = 0
        for root in range(n):
            if index[root] != -1:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter
                    counter += 1
                    stack.append(v)
                    on_stack[v] = True
                recurse = False
                out = self._out[v]
                for i in range(pi, len(out)):
                    w = self.edge_targets[out[i]]
                    if index[w] == -1:
                        work[-1] = (v, i + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    elif on_stack[w]:
                        low[v] = min(low[v], index[w])
                if recurse:
                    continue
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp.append(w)
                        if w == v:
                            break
                    comps.append(comp)
                work.pop()
                if work:
                    u, _ = work[-1]
                    low[u] = min(low[u], low[v])
        return comps

    def weakly_connected_components(self) -> List[List[int]]:
        n = self.n_nodes()
        seen = [False] * n
        comps = []
        for root in range(n):
            if seen[root]:
                continue
            comp = []
            bfs = [root]
            seen[root] = True
            while bfs:
                v = bfs.pop()
                comp.append(v)
                for e in self._out[v]:
                    w = self.edge_targets[e]
                    if not seen[w]:
                        seen[w] = True
                        bfs.append(w)
                for e in self._in[v]:
                    w = self.edge_sources[e]
                    if not seen[w]:
                        seen[w] = True
                        bfs.append(w)
            comps.append(comp)
        return comps

    def __repr__(self) -> str:
        return f"DiGraph(n_nodes={self.n_nodes()}, n_edges={self.n_edges()})"
