"""Hash-based k-mer counting DBG — the draft-stage construction
(ref: src/hashdbg.rs).

``HashDbg`` maps k-mer (bytes) -> count.  Edge-centric view: the k-mer is an
edge between its (k-1)-mer prefix and suffix nodes.  Cleaning = rare-kmer
removal, iterative deadend trimming, terminal augmentation ('nnnA...' margin
paths), largest weakly-connected component.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import kmer as km
from .graph.digraph import DiGraph
from .seq.collection import NULL_BASE, StyledSequence


class HashDbg:
    def __init__(self, k: int):
        self.k = k
        self.kmers: Dict[bytes, int] = {}

    # -- construction (ref: hashdbg.rs:36-260) --------------------------------

    @staticmethod
    def from_kmers(k: int, kmers_and_counts: Iterable[Tuple[bytes, int]]) -> "HashDbg":
        d = HashDbg(k)
        for kmer, c in kmers_and_counts:
            assert len(kmer) == k
            d.kmers[bytes(kmer)] = c
        return d

    @staticmethod
    def from_fragment_seqs(k: int, seqs: Iterable[bytes]) -> "HashDbg":
        """Count k-mers of reads treated as fragments (no margins); reads
        shorter than k are skipped (ref: hashdbg.rs:232-245).

        Counting stays in Python: CPython's bytes-keyed dict is faster than
        marshalling results back from a native counter (measured 3x)."""
        d = HashDbg(k)
        for seq in seqs:
            if len(seq) >= k:
                for i in range(len(seq) - k + 1):
                    d.add(seq[i : i + k], 1)
        return d

    @staticmethod
    def from_styled_seqs(k: int, seqs: Iterable[StyledSequence]) -> "HashDbg":
        d = HashDbg(k)
        for s in seqs:
            for kmer in km.styled_sequence_to_kmers(s, k):
                d.add(kmer, 1)
        return d

    # -- basic ops ------------------------------------------------------------

    def get(self, kmer: bytes) -> int:
        return self.kmers.get(kmer, 0)

    def set(self, kmer: bytes, c: int) -> None:
        self.kmers[bytes(kmer)] = c

    def add(self, kmer: bytes, c: int) -> None:
        self.kmers[kmer] = self.kmers.get(kmer, 0) + c

    def remove(self, kmer: bytes) -> None:
        self.kmers.pop(kmer, None)

    def has(self, kmer: bytes) -> bool:
        return kmer in self.kmers

    def n(self) -> int:
        return len(self.kmers)

    def edges(self) -> List[bytes]:
        return list(self.kmers.keys())

    def childs(self, kmer: bytes) -> List[bytes]:
        return [c for c in km.childs(kmer) if c in self.kmers]

    def parents(self, kmer: bytes) -> List[bytes]:
        return [p for p in km.parents(kmer) if p in self.kmers]

    # -- cleaning (ref: hashdbg.rs:333-469) -----------------------------------

    def remove_rare_kmers(self, min_count: int) -> int:
        dead = [kmer for kmer, c in self.kmers.items() if c < min_count]
        for kmer in dead:
            del self.kmers[kmer]
        return len(dead)

    def is_deadend(self, kmer: bytes) -> bool:
        return not self.childs(kmer) or not self.parents(kmer)

    def remove_deadends(self, min_count: int) -> int:
        """Iteratively remove deadend k-mers with count < min_count
        (ref: hashdbg.rs:349-379)."""
        stack = [
            e for e in self.edges() if self.get(e) < min_count and self.is_deadend(e)
        ]
        n_removed = 0
        while stack:
            deadend = stack.pop()
            if deadend not in self.kmers:
                continue
            self.remove(deadend)
            n_removed += 1
            for nb in self.childs(deadend) + self.parents(deadend):
                if self.is_deadend(nb) and self.get(nb) < min_count:
                    stack.append(nb)
        return n_removed

    def add_starting_kmers(self, kmer: bytes) -> None:
        """nnnA, nnAG, nAGC for AGCT (ref: hashdbg.rs:380-388)."""
        c = self.get(kmer)
        n = bytes([NULL_BASE])
        for i in range(1, self.k):
            # n^(k-i) + kmer[:i]
            self.add(n * (self.k - i) + kmer[:i], c)

    def add_ending_kmers(self, kmer: bytes) -> None:
        """GCTn, CTnn, Tnnn for AGCT."""
        c = self.get(kmer)
        n = bytes([NULL_BASE])
        for i in range(1, self.k):
            self.add(kmer[i:] + n * i, c)

    def augment_deadends(self) -> Tuple[List[bytes], List[bytes]]:
        """Connect remaining deadends to the terminal via margin paths
        (ref: hashdbg.rs:404-425)."""
        starts, ends = [], []
        for e in self.edges():
            if not self.parents(e):
                self.add_starting_kmers(e)
                starts.append(e)
            if not self.childs(e):
                self.add_ending_kmers(e)
                ends.append(e)
        return starts, ends

    def connected_components(self) -> List[List[bytes]]:
        """Weakly connected components as k-mer sets, descending by size
        (ref: hashdbg.rs:430-455; kosaraju on the underlying graph -- edges of
        a weak component = in-edges of its nodes)."""
        g, _ids, edge_kmers = self._graph_with_ids()
        comps = g.weakly_connected_components()
        out = []
        for comp in comps:
            comp_set = set(comp)
            kmers = [
                edge_kmers[e]
                for e in range(g.n_edges())
                if g.edge_targets[e] in comp_set
            ]
            out.append(kmers)
        out.sort(key=len, reverse=True)
        return out

    def largest_component(self) -> "HashDbg":
        comps = self.connected_components()
        if not comps:
            return HashDbg(self.k)
        return HashDbg.from_kmers(self.k, [(e, self.get(e)) for e in comps[0]])

    # -- graph view (ref: hashdbg.rs:289-313) ---------------------------------

    def _graph_with_ids(self):
        g = DiGraph()
        ids: Dict[bytes, int] = {}
        # deterministic node order: sorted (k-1)-mers
        nodes = set()
        for kmer in self.kmers:
            nodes.add(km.prefix(kmer))
            nodes.add(km.suffix(kmer))
        for node in sorted(nodes):
            ids[node] = g.add_node(node)
        edge_kmers: List[bytes] = []
        for kmer in sorted(self.kmers):
            g.add_edge(ids[km.prefix(kmer)], ids[km.suffix(kmer)], kmer)
            edge_kmers.append(kmer)
        return g, ids, edge_kmers

    def to_graph(
        self,
        node_fn: Callable[[bytes], object],
        edge_fn: Callable[[bytes], object],
    ) -> DiGraph:
        """Edge-centric full DBG: node = (k-1)-mer, edge = k-mer.  Iteration
        order is sorted-k-mer, so indices are deterministic."""
        g, _ids, _ek = self._graph_with_ids()
        return g.map(lambda _v, w: node_fn(w), lambda _e, w: edge_fn(w))

    def is_copy_nums_consistent(self) -> bool:
        nodes = set()
        for kmer in self.kmers:
            nodes.add(km.prefix(kmer))
            nodes.add(km.suffix(kmer))
        # in-edges of node X = kmers [bX]; out-edges = [Xb]
        for node in nodes:
            n_in = sum(
                self.get(bytes([b]) + node) for b in b"ACGT" + bytes([NULL_BASE])
            )
            n_out = sum(
                self.get(node + bytes([b])) for b in b"ACGT" + bytes([NULL_BASE])
            )
            if n_in != n_out:
                return False
        return True

    def degree_stats(self) -> Dict[Tuple[int, int], int]:
        g, _ids, _ek = self._graph_with_ids()
        stats: Dict[Tuple[int, int], int] = {}
        for v in range(g.n_nodes()):
            key = (g.in_degree(v), g.out_degree(v))
            stats[key] = stats.get(key, 0) + 1
        return stats

    def copy_num_stats(self) -> Dict[int, int]:
        stats: Dict[int, int] = {}
        for c in self.kmers.values():
            stats[c] = stats.get(c, 0) + 1
        return stats

    # -- GFA output (ref: hashdbg.rs:597-660 to_gfa_writer) -------------------

    def to_gfa_string(self) -> str:
        """GFA of the raw count graph: one segment per compacted unitig with
        average count in DP, links at branch nodes.  Works on uncleaned
        graphs (no k-mer-string recovery via graph walk needed — the k-mers
        are stored)."""
        from .graph.compact import compact_simple_paths
        from . import kmer as km

        full = self.to_graph(lambda km1: km1, lambda kmer: kmer)
        cg, _nm = compact_simple_paths(full)
        lines = []
        for e in range(cg.n_edges()):
            path = cg.edge(e)  # [(orig_edge, kmer)]
            kmers = [w for _o, w in path]
            seq = km.kmers_join(kmers)
            counts = [self.get(x) for x in kmers]
            dp = sum(counts) / len(counts) if counts else 0.0
            lines.append(
                f"S\t{e}\t{seq.decode('ascii')}\tDP:f:{dp:.1f}\tLN:i:{len(seq)}"
            )
        for v in range(cg.n_nodes()):
            for in_e, _p, _w in cg.parents(v):
                for out_e, _c, _w2 in cg.childs(v):
                    lines.append(f"L\t{in_e}\t+\t{out_e}\t+\t{self.k - 1}M")
        return "\n".join(lines) + "\n"

    def to_gfa_file(self, path) -> None:
        from pathlib import Path

        Path(path).write_text(self.to_gfa_string())
