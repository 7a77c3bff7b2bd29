"""Bipartite container: dense in-node x out-node edge matrix.

The reference uses this to model the (in-edges x out-edges) intersection at
each k-mer node (ref: src/graph/bipartite.rs:26-120).  Edges are stored in a
flat row-major list of length ``n_in * n_out``.
"""

from __future__ import annotations

from typing import Any, Callable, Generic, List, TypeVar

I = TypeVar("I")
N = TypeVar("N")
E = TypeVar("E")


class Bipartite(Generic[I, N, E]):
    """Complete bipartite graph between ``in_nodes`` and ``out_nodes``."""

    __slots__ = ("id", "in_nodes", "out_nodes", "edges")

    def __init__(self, id: I, in_nodes: List[N], out_nodes: List[N], edges: List[E]):
        if len(edges) != len(in_nodes) * len(out_nodes):
            raise ValueError("edges must have n_in * n_out entries")
        self.id = id
        self.in_nodes = in_nodes
        self.out_nodes = out_nodes
        self.edges = edges

    @classmethod
    def from_fn(
        cls,
        id: I,
        in_nodes: List[N],
        out_nodes: List[N],
        edge_fn: Callable[[int, int], E],
    ) -> "Bipartite[I, N, E]":
        edges = [
            edge_fn(i, j)
            for i in range(len(in_nodes))
            for j in range(len(out_nodes))
        ]
        return cls(id, in_nodes, out_nodes, edges)

    def n_in(self) -> int:
        return len(self.in_nodes)

    def n_out(self) -> int:
        return len(self.out_nodes)

    def in_node(self, index: int) -> N:
        return self.in_nodes[index]

    def out_node(self, index: int) -> N:
        return self.out_nodes[index]

    def edge_index(self, index_in: int, index_out: int) -> int:
        if not (0 <= index_in < self.n_in() and 0 <= index_out < self.n_out()):
            raise IndexError((index_in, index_out))
        return index_in * self.n_out() + index_out

    def edge(self, index_in: int, index_out: int) -> E:
        return self.edges[self.edge_index(index_in, index_out)]

    def iter_edges(self):
        """Yield (index_in, index_out, edge) row-major."""
        for i in range(self.n_in()):
            for j in range(self.n_out()):
                yield i, j, self.edges[self.edge_index(i, j)]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Bipartite(id={self.id!r}, n_in={self.n_in()}, "
            f"n_out={self.n_out()})"
        )
