"""Multi-k de Bruijn graph — the central data structure of the assembler
(ref: src/multi_dbg.rs).

``MultiDbg`` holds the **full** edge-centric DBG (edge = k-mer with emission
base + copy number; node = (k-1)-mer) and the simple-path-collapsed
**compact** graph (edge weight = ordered list of full-edge indices).  K-mer
strings are never stored — they are recovered by walking the graph
(``km1mer_full``).

Key operations: copy-number vectors over compact edges (flow-consistent),
k+1 extension via the node-centric transform, purging of 0-copy edges with
index remapping, conversion to PHMM arrays for the device kernels, Euler
circuit extraction for assembly emission.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.compact import compact_simple_paths
from ..graph.digraph import DiGraph
from ..graph.euler import euler_circuit, euler_circuit_count
from ..graph.utils import bridge_edges
from ..kmer import kmers_join
from ..phmm.model import BASE_TO_CODE, PHMMModel, _adjacency_arrays
from ..phmm.params import PHMMParams
from ..prob import NEG_INF
from ..seq.collection import NULL_BASE, SeqStyle, StyledSequence

Path = List[int]  # list of edge indices in full graph


@dataclass
class MultiFullNode:
    is_terminal: bool


@dataclass
class MultiFullEdge:
    base: int  # emission byte (last base of k-mer); NULL_BASE for margins
    copy_num: int

    def is_null_base(self) -> bool:
        return self.base == NULL_BASE


@dataclass
class MultiCompactNode:
    is_terminal: bool
    node_in_full: int


@dataclass
class MultiCompactEdge:
    edges_in_full: List[int]


class MultiDbg:
    def __init__(self, k: int, full: DiGraph, compact: Optional[DiGraph] = None):
        self.k = k
        self.full = full
        self.compact = (
            compact if compact is not None else self.construct_compact_from_full(full)
        )

    # -- construction ---------------------------------------------------------

    @staticmethod
    def construct_compact_from_full(full: DiGraph) -> DiGraph:
        """Simple-path collapse protecting the terminal node
        (ref: multi_dbg.rs:1447-1458)."""
        cg, node_map = compact_simple_paths(
            full, is_target=lambda w: not w.is_terminal
        )
        inv = {cv: fv for fv, cv in node_map.items()}
        return cg.map(
            lambda v, w: MultiCompactNode(w.is_terminal, inv[v]),
            lambda _e, path: MultiCompactEdge([e for e, _w in path]),
        )

    @staticmethod
    def from_hashdbg(hashdbg, ignore_copy_num: bool = False) -> "MultiDbg":
        """(ref: multi_dbg.rs:195-221)"""
        if not ignore_copy_num:
            assert hashdbg.is_copy_nums_consistent(), "inconsistent copy numbers"
        from ..kmer import is_null, emission

        full = hashdbg.to_graph(
            lambda km1mer: MultiFullNode(is_null(km1mer)),
            lambda kmer: MultiFullEdge(
                emission(kmer), 0 if ignore_copy_num else hashdbg.get(kmer)
            ),
        )
        return MultiDbg(hashdbg.k, full)

    @staticmethod
    def from_styled_seqs(k: int, seqs: Sequence[StyledSequence]) -> "MultiDbg":
        """Build the true DBG of a genome (used for toys/tests)."""
        from ..hashdbg import HashDbg

        return MultiDbg.from_hashdbg(HashDbg.from_styled_seqs(k, seqs))

    def copy(self) -> "MultiDbg":
        full = self.full.map(
            lambda _v, w: MultiFullNode(w.is_terminal),
            lambda _e, w: MultiFullEdge(w.base, w.copy_num),
        )
        compact = self.compact.map(
            lambda _v, w: MultiCompactNode(w.is_terminal, w.node_in_full),
            lambda _e, w: MultiCompactEdge(list(w.edges_in_full)),
        )
        return MultiDbg(self.k, full, compact)

    # -- sizes / accessors ----------------------------------------------------

    def n_nodes_full(self) -> int:
        return self.full.n_nodes()

    def n_edges_full(self) -> int:
        return self.full.n_edges()

    def n_nodes_compact(self) -> int:
        return self.compact.n_nodes()

    def n_edges_compact(self) -> int:
        return self.compact.n_edges()

    def base(self, edge_in_full: int) -> int:
        return self.full.edge(edge_in_full).base

    def copy_num(self, edge_in_full: int) -> int:
        return self.full.edge(edge_in_full).copy_num

    def edges_in_full(self, edge_in_compact: int) -> List[int]:
        return self.compact.edge(edge_in_compact).edges_in_full

    def n_bases(self, edge_in_compact: int) -> int:
        """# of k-mers (full edges) of a compact edge."""
        return len(self.edges_in_full(edge_in_compact))

    def terminal_node_full(self) -> Optional[int]:
        for v, w in self.full.nodes():
            if w.is_terminal:
                return v
        return None

    def terminal_node_compact(self) -> Optional[int]:
        for v, w in self.compact.nodes():
            if w.is_terminal:
                return v
        return None

    def node_in_compact_to_full(self, node_in_compact: int) -> int:
        return self.compact.node(node_in_compact).node_in_full

    def n_emittable_edges(self) -> int:
        return sum(1 for _e, _s, _t, w in self.full.edges() if not w.is_null_base())

    def n_ambiguous_node(self) -> int:
        """# of nodes with in-deg > 1 and out-deg > 1 (and positive copies) in
        full — k+1 copy numbers are not unique there (ref: multi_dbg.rs)."""
        n = 0
        for v in range(self.full.n_nodes()):
            n_in = sum(
                1 for e, _p, w in self.full.parents(v) if w.copy_num > 0
            )
            n_out = sum(1 for e, _c, w in self.full.childs(v) if w.copy_num > 0)
            if n_in > 1 and n_out > 1:
                n += 1
        return n

    # -- copy numbers (ref: multi_dbg.rs:988-1134) ----------------------------

    def is_copy_nums_valid(self) -> bool:
        for v in range(self.full.n_nodes()):
            c_in = sum(w.copy_num for _e, _p, w in self.full.parents(v))
            c_out = sum(w.copy_num for _e, _c, w in self.full.childs(v))
            if c_in != c_out:
                return False
        return True

    def genome_size(self) -> int:
        return sum(
            w.copy_num
            for _e, _s, _t, w in self.full.edges()
            if not w.is_null_base()
        )

    def max_copy_num(self) -> int:
        return max((w.copy_num for _e, _s, _t, w in self.full.edges()), default=0)

    def copy_num_of_edge_in_compact(self, edge_in_compact: int) -> int:
        return self.copy_num(self.edges_in_full(edge_in_compact)[0])

    def get_copy_nums(self) -> List[int]:
        return [
            self.copy_num_of_edge_in_compact(e) for e in range(self.n_edges_compact())
        ]

    def set_copy_nums(self, copy_nums: Sequence[int]) -> None:
        assert len(copy_nums) == self.n_edges_compact()
        for e in range(self.n_edges_compact()):
            for ef in self.edges_in_full(e):
                self.full.edge(ef).copy_num = int(copy_nums[e])
        assert self.is_copy_nums_valid(), "invalid new copy_nums"

    @staticmethod
    def guess_copy_num(copy_num_ins: List[int], copy_num_outs: List[int]) -> List[List[int]]:
        """Deterministic round-robin distribution of parent copy numbers onto
        (in, out) pairs at a node (ref: multi_dbg.rs:1104-1133)."""
        assert sum(copy_num_ins) == sum(copy_num_outs)
        n_in, n_out = len(copy_num_ins), len(copy_num_outs)
        out = [[0] * n_out for _ in range(n_in)]
        rem_in = list(copy_num_ins)
        rem_out = list(copy_num_outs)
        while any(x > 0 for x in rem_in) and any(x > 0 for x in rem_out):
            for i in range(n_in):
                for j in range(n_out):
                    if rem_in[i] > 0 and rem_out[j] > 0:
                        out[i][j] += 1
                        rem_in[i] -= 1
                        rem_out[j] -= 1
        return out

    def copy_num_of_node(self, node_in_full: int) -> int:
        return sum(w.copy_num for _e, _p, w in self.full.parents(node_in_full))

    # -- k-mer recovery (ref: multi_dbg.rs:840-988) ---------------------------

    def km1mer_full(self, node_in_full: int) -> bytes:
        bases = bytearray()
        node = node_in_full
        while len(bases) < self.k - 1:
            parents = self.full.parents(node)
            assert parents, "no incoming edge while recovering k-1-mer"
            e, p, w = parents[0]
            bases.append(w.base)
            node = p
        bases.reverse()
        return bytes(bases)

    def kmer_full(self, edge_in_full: int) -> bytes:
        s, _t = self.full.edge_endpoints(edge_in_full)
        return self.km1mer_full(s) + bytes([self.base(edge_in_full)])

    def km1mer_compact(self, node_in_compact: int) -> bytes:
        return self.km1mer_full(self.node_in_compact_to_full(node_in_compact))

    def kmer_compact(self, edge_in_compact: int) -> bytes:
        s, _t = self.compact.edge_endpoints(edge_in_compact)
        out = bytearray(self.km1mer_compact(s))
        for ef in self.edges_in_full(edge_in_compact):
            out.append(self.base(ef))
        return bytes(out)

    def seq_compact(self, edge_in_compact: int) -> bytes:
        return bytes(self.base(ef) for ef in self.edges_in_full(edge_in_compact))

    def to_kmer_map(self) -> Dict[bytes, int]:
        return {self.kmer_full(e): e for e in range(self.n_edges_full())}

    def to_kmer_copy_num_map(self) -> Dict[bytes, int]:
        return {
            self.kmer_full(e): self.copy_num(e) for e in range(self.n_edges_full())
        }

    def paths_from_styled_seqs(self, seqs) -> List[Path]:
        """Genome -> true paths; raises KeyError listing missing k-mers
        (ref: multi_dbg.rs:950-987)."""
        from ..kmer import styled_sequence_to_kmers

        m = self.to_kmer_map()
        paths = []
        missing = []
        for s in seqs:
            path = []
            for kmer in styled_sequence_to_kmers(s, self.k):
                if kmer in m:
                    path.append(m[kmer])
                else:
                    missing.append(kmer)
            paths.append(path)
        if missing:
            raise KmerNotFoundError(missing)
        return paths

    def paths_from_styled_seqs_partial(self, seqs) -> List[Optional[Path]]:
        """Per-haplotype best-effort variant: a haplotype whose k-mers are
        all present yields its path; one with missing k-mers yields None
        (tracking continues for the still-contained subset — a mid-run
        purge that broke one haplotype must not disable the truth diff for
        the other; VERDICT r4 item 8)."""
        from ..kmer import styled_sequence_to_kmers

        m = self.to_kmer_map()
        paths: List[Optional[Path]] = []
        for s in seqs:
            path = []
            for kmer in styled_sequence_to_kmers(s, self.k):
                e = m.get(kmer)
                if e is None:
                    path = None
                    break
                path.append(e)
            paths.append(path)
        return paths

    # -- node-centric transform & k+1 (ref: multi_dbg.rs:1136-1604) ----------

    def to_node_centric_graph(
        self,
        to_node: Callable[[int, MultiFullEdge], object],
        to_terminal_node: Callable[[], object],
        to_edge: Callable[[int, int, int], object],
        to_terminal_edge: Callable[[int], object],
        add_terminal: bool,
    ) -> DiGraph:
        """Line-graph-like transform: edge of G -> node of G' (same index);
        (in,out) edge pairs at non-terminal nodes -> edges of G'; terminal
        node re-inserted explicitly when requested."""
        g = DiGraph()
        for e in range(self.n_edges_full()):
            v = g.add_node(to_node(e, self.full.edge(e)))
            assert v == e
        for node in range(self.n_nodes_full()):
            w = self.full.node(node)
            if w.is_terminal:
                if add_terminal:
                    t = g.add_node(to_terminal_node())
                    for e, _p, _w in self.full.parents(node):
                        g.add_edge(e, t, to_terminal_edge(e))
                    for e, _c, _w in self.full.childs(node):
                        g.add_edge(t, e, to_terminal_edge(e))
            else:
                for e1, _p, _w1 in self.full.parents(node):
                    for e2, _c, _w2 in self.full.childs(node):
                        g.add_edge(e1, e2, to_edge(e1, e2, node))
        return g

    def guess_copy_num_of_kp1_edge(self, node: int, edge_in: int, edge_out: int) -> int:
        parents = self.full.parents(node)
        childs = self.full.childs(node)
        copy_ins = [w.copy_num for _e, _p, w in parents]
        copy_outs = [w.copy_num for _e, _c, w in childs]
        i_in = next(i for i, (e, _p, _w) in enumerate(parents) if e == edge_in)
        i_out = next(i for i, (e, _c, _w) in enumerate(childs) if e == edge_out)
        return MultiDbg.guess_copy_num(copy_ins, copy_outs)[i_in][i_out]

    def _full_arrays(self) -> "FullArrays":
        """Snapshot the full graph as plain numpy arrays (the array-resident
        representation used by the k+1 extension jump)."""
        g = self.full
        n_v, n_e = g.n_nodes(), g.n_edges()
        return FullArrays(
            n_nodes=n_v,
            terminal=next(
                (v for v in range(n_v) if g.node(v).is_terminal), None
            ),
            srcs=np.asarray(g.edge_sources, dtype=np.int64),
            tgts=np.asarray(g.edge_targets, dtype=np.int64),
            copy=np.fromiter(
                (w.copy_num for w in g.edge_weights), dtype=np.int64, count=n_e
            ),
            bases=np.fromiter(
                (w.base for w in g.edge_weights), dtype=np.int64, count=n_e
            ),
        )

    @staticmethod
    def _from_full_arrays(k: int, fa: "FullArrays") -> "MultiDbg":
        """Materialize a MultiDbg from the array representation."""
        full = DiGraph()
        full.node_weights = [
            MultiFullNode(v == fa.terminal) for v in range(fa.n_nodes)
        ]
        full.edge_sources = [int(x) for x in fa.srcs]
        full.edge_targets = [int(x) for x in fa.tgts]
        full.edge_weights = [
            MultiFullEdge(int(b), int(c)) for b, c in zip(fa.bases, fa.copy)
        ]
        full._out = [[] for _ in range(fa.n_nodes)]
        full._in = [[] for _ in range(fa.n_nodes)]
        for e, (s, t) in enumerate(zip(full.edge_sources, full.edge_targets)):
            full._out[s].append(e)
            full._in[t].append(e)
        return MultiDbg(k, full)

    def to_kp1_dbg(self) -> "MultiDbg":
        """k+1 extension (ref: multi_dbg.rs:1177-1206).

        Vectorized line-graph transform — the generic
        ``to_node_centric_graph`` costs ~0.3-0.5s of Python per stage at
        production graph sizes and the unambiguous-extension jump runs
        hundreds to thousands of stages (k_max up to 20,000).  Node/edge
        indices and ordering are IDENTICAL to the loop construction
        (verified by tests/test_multi_dbg.py::test_to_kp1_fast_matches_loop).
        Copy numbers: nodes with in- or out-degree 1 split trivially;
        ambiguous nodes fall back to guess_copy_num.

        The multi-stage jump inside :meth:`purge_and_extend` stays in array
        land (``_kp1_arrays``) and materializes a MultiDbg only once."""
        return MultiDbg._from_full_arrays(self.k + 1, _kp1_arrays(self._full_arrays()))

    def path_kp1_from_path_k(self, path_k: Path) -> Path:
        """(ref: multi_dbg.rs:1248-1292)"""
        n = len(path_k)
        path: Path = []
        kp1 = self  # NOTE: call on the k+1 dbg with a path of the k dbg
        terminal = kp1.terminal_node_full()
        first, last = path_k[0], path_k[n - 1]
        start = kp1.full.find_edge(terminal, first) if terminal is not None else None
        end = kp1.full.find_edge(last, terminal) if terminal is not None else None
        if start is not None and end is not None:
            path.append(start)
            for i in range(n - 1):
                e = kp1.full.find_edge(path_k[i], path_k[i + 1])
                assert e is not None, "invalid path"
                path.append(e)
            path.append(end)
        else:
            for i in range(n):
                e = kp1.full.find_edge(path_k[i], path_k[(i + 1) % n])
                assert e is not None, "invalid path"
                path.append(e)
        return path

    def hint_kp1_from_hint_k(self, nodes_k: List[List[int]]) -> List[List[int]]:
        """Upconvert mapping node lists: node v in k-HMM (= full k-edge = k+1
        full node) maps to all in-edges of v in the k+1 graph
        (ref: multi_dbg.rs:1325-1334). Call on the k+1 dbg."""
        out = []
        for per_base in nodes_k:
            lst: List[int] = []
            for v in per_base:
                for e, _p, _w in self.full.parents(v):
                    lst.append(e)
            out.append(lst)
        return out

    # -- purge (ref: multi_dbg.rs:1607-1792) ----------------------------------

    def purge_edges(
        self, edges_in_compact: Sequence[int]
    ) -> Tuple["MultiDbg", Dict[int, Optional[int]], Dict[int, Optional[int]]]:
        """Remove compact edges (and resulting bridge edges) + their full
        edges; returns (new_dbg, full_edge_map, compact_edge_map) where maps
        take old index -> new index or None if deleted."""
        dead_compact = set(edges_in_compact)
        # bridges that appear after removal: compute on the graph sans dead
        tmp, _nm, em_tmp = self.compact.remove_edges(dead_compact)
        inv_tmp = {new: old for old, new in em_tmp.items()}
        for b in bridge_edges(tmp):
            dead_compact.add(inv_tmp[b])

        dead_full = set()
        for e in dead_compact:
            dead_full.update(self.edges_in_full(e))

        new_full, _nm_full, em_full = self.full.remove_edges(dead_full)
        new_compact_raw, _nm_c, em_compact = self.compact.remove_edges(dead_compact)
        # rewrite edges_in_full with new indices
        new_compact = new_compact_raw.map(
            lambda _v, w: MultiCompactNode(w.is_terminal, w.node_in_full),
            lambda _e, w: MultiCompactEdge([em_full[ef] for ef in w.edges_in_full]),
        )
        # fix node_in_full indices
        for v in range(new_compact.n_nodes()):
            w = new_compact.node(v)
            # recover via first in/out compact edge's full endpoint
            if new_compact.out_edges(v):
                e0 = new_compact.out_edges(v)[0]
                ef0 = new_compact.edge(e0).edges_in_full[0]
                w.node_in_full = new_full.edge_sources[ef0]
            elif new_compact.in_edges(v):
                e0 = new_compact.in_edges(v)[0]
                ef0 = new_compact.edge(e0).edges_in_full[-1]
                w.node_in_full = new_full.edge_targets[ef0]

        full_map = {e: em_full.get(e) for e in range(self.n_edges_full())}
        compact_map = {e: em_compact.get(e) for e in range(self.n_edges_compact())}
        return MultiDbg(self.k, new_full, new_compact), full_map, compact_map

    def purge_and_extend(
        self,
        edges_in_compact_to_purge: Sequence[int],
        k_max: int,
        stop_when_ambiguous: bool = True,
        paths: Optional[List[Path]] = None,
        mappings=None,
        max_hint_stages: int = 64,
    ):
        """(ref: multi_dbg.rs:1685-1746)

        The k+1 jump runs entirely on the array representation
        (``_kp1_arrays``) — path and mapping upconversion are vectorized per
        stage and a MultiDbg is materialized only once at the target k.

        ``mappings``: per-read hint node sets; accepts list-of-lists rows or
        a padded int array [L, A] (-1 pad) per read; always RETURNED as
        padded arrays.  ``max_hint_stages``: the hint width can grow through
        high-in-degree stretches; past this many stages the hint is dropped
        (returned as None) and the caller regenerates at the target k."""
        dbg, full_map, _cm = self.purge_edges(edges_in_compact_to_purge)
        if paths is not None:
            new_paths = []
            for p in paths:
                if p is None:  # lost in an earlier purge (true edge removed)
                    new_paths.append(None)
                    continue
                q = [full_map[e] for e in p]
                new_paths.append(None if any(x is None for x in q) else q)
            paths = new_paths
        if mappings is not None:
            # remap through the purge and normalize to padded arrays
            fm = np.full(self.n_edges_full() + 1, -1, dtype=np.int64)
            for old, new in full_map.items():
                fm[old] = -1 if new is None else new
            arrs = []
            for mp in mappings:
                if not isinstance(mp, np.ndarray):
                    w = max(1, max((len(row) for row in mp), default=1))
                    a = np.full((len(mp), w), -1, dtype=np.int64)
                    for j, row in enumerate(mp):
                        a[j, : len(row)] = row
                    mp = a
                mp = mp.astype(np.int64, copy=False)
                arrs.append(np.where(mp >= 0, fm[mp], -1))
            mappings = arrs

        fa = dbg._full_arrays()
        k = dbg.k
        stages = 0
        while k < k_max:
            assert _copy_nums_valid_arrays(fa), "invalid copy nums"
            was_ambiguous = _n_ambiguous_arrays(fa) > 0
            fa2 = _kp1_arrays(fa)
            assert _copy_nums_valid_arrays(fa2), "k+1 broke copy nums"
            if paths is not None:
                paths = _paths_kp1_arrays(fa2, paths)
            stages += 1
            if mappings is not None:
                if stages > max_hint_stages:
                    mappings = None  # cheaper to regenerate at the target k
                else:
                    order_in, starts, in_deg = _in_csr(fa2)
                    mappings = [
                        _hint_kp1_array(mp, order_in, starts, in_deg)
                        for mp in mappings
                    ]
            fa = fa2
            k += 1
            if stop_when_ambiguous and was_ambiguous:
                break
        if k > dbg.k:
            dbg = MultiDbg._from_full_arrays(k, fa)
        return dbg, paths, mappings

    # -- PHMM conversion (ref: multi_dbg.rs:1363-1438) ------------------------

    def to_phmm(self, params: PHMMParams, mode: str = "normal") -> PHMMModel:
        """PHMM over full edges: node of HMM = edge (k-mer) of full graph;
        transitions through non-terminal (k-1)-mer nodes only (the terminal
        breaks sequences, add_terminal=False).  ``mode`` in
        {"normal", "uniform", "non_zero"} (ref: seq_graph.rs:160-273).

        Sets ``n_warmup = k`` as the reference does (multi_dbg.rs:1395).
        """
        n = self.n_edges_full()
        emission = np.empty(n, dtype=np.uint8)
        copy = np.zeros(n, dtype=np.int64)
        for e in range(n):
            w = self.full.edge(e)
            emission[e] = BASE_TO_CODE[w.base]
            copy[e] = w.copy_num
        emittable = emission < 4
        min_copy = 1 if mode == "non_zero" else 0
        eff = np.where(emittable, np.maximum(copy, min_copy), 0)

        init_logp = np.full(n, NEG_INF)
        if mode == "uniform":
            n_emit = int(emittable.sum())
            if n_emit:
                init_logp[emittable] = -np.log(n_emit)
        else:
            total = eff.sum()
            pos = emittable & (eff > 0)
            if total > 0:
                init_logp[pos] = np.log(eff[pos]) - np.log(total)

        # adjacency of the HMM: for each non-terminal full node v, each
        # (in-edge e1, out-edge e2) pair is an HMM transition e1 -> e2
        max_deg = 2
        for v in range(self.n_nodes_full()):
            if not self.full.node(v).is_terminal:
                max_deg = max(max_deg, self.full.in_degree(v), self.full.out_degree(v))
        parent_idx = np.zeros((n, max_deg), dtype=np.int32)
        parent_logt = np.full((n, max_deg), NEG_INF)
        child_idx = np.zeros((n, max_deg), dtype=np.int32)
        child_logt = np.full((n, max_deg), NEG_INF)

        for v in range(self.n_nodes_full()):
            if self.full.node(v).is_terminal:
                continue
            ins = self.full.parents(v)
            outs = self.full.childs(v)
            if mode == "uniform":
                n_emit_childs = sum(1 for e2, _c, _w in outs if emittable[e2])
                logt_of = lambda e2: (
                    -np.log(n_emit_childs)
                    if emittable[e2] and n_emit_childs > 0
                    else NEG_INF
                )
            else:
                total_child = sum(int(eff[e2]) for e2, _c, _w in outs if emittable[e2])
                logt_of = lambda e2: (
                    np.log(eff[e2]) - np.log(total_child)
                    if emittable[e2] and total_child > 0 and eff[e2] > 0
                    else NEG_INF
                )
            for e1, _p, _w1 in ins:
                for j2, (e2, _c, _w2) in enumerate(outs):
                    child_idx[e1, j2] = e2
                    child_logt[e1, j2] = logt_of(e2)
            for e2, _c, _w2 in outs:
                lt = logt_of(e2)
                for j1, (e1, _p, _w1) in enumerate(ins):
                    parent_idx[e2, j1] = e1
                    parent_logt[e2, j1] = lt

        import dataclasses

        p2 = dataclasses.replace(
            params,
            p_mismatch=params.p_mismatch,
            p_gap_open=params.p_gap_open,
            p_gap_ext=params.p_gap_ext,
            p_end=params.p_end,
            n_warmup=self.k,
        )
        return PHMMModel(
            params=p2,
            emission=emission,
            init_logp=init_logp,
            parent_idx=parent_idx,
            parent_logt=parent_logt,
            child_idx=child_idx,
            child_logt=child_logt,
        )

    # -- euler output (ref: multi_dbg.rs:560-690) -----------------------------

    def get_euler_circuit_compact(self) -> List[int]:
        """Single Euler circuit over compact edges respecting copy numbers,
        starting from the terminal node."""
        terminal = self.terminal_node_compact()
        assert terminal is not None, "no terminal node"
        copy_nums = self.get_copy_nums()
        # deterministic child order: by first base of the edge seq
        prio = {
            e: self.base(self.edges_in_full(e)[0])
            for e in range(self.n_edges_compact())
        }
        return euler_circuit(self.compact, copy_nums, terminal, child_priority=prio)

    def get_linear_haplotype_seqs(self) -> List[Tuple[StyledSequence, List[int]]]:
        terminal = self.terminal_node_compact()
        assert terminal is not None
        ret = []
        seq = bytearray()
        cycle: List[int] = []
        for edge in self.get_euler_circuit_compact():
            seq.extend(self.seq_compact(edge))
            cycle.append(edge)
            _s, t = self.compact.edge_endpoints(edge)
            if t == terminal:
                trimmed = bytes(b for b in seq if b != NULL_BASE)
                ret.append((StyledSequence.linear(trimmed), cycle))
                seq = bytearray()
                cycle = []
        return ret

    def to_fasta_linear(self, path) -> None:
        from ..seq.io import write_fasta

        recs = []
        for seq, cycle in self.get_linear_haplotype_seqs():
            name = ",".join(str(e) for e in cycle)
            recs.append((name, None, seq.seq))
        write_fasta(path, recs)

    def get_euler_circuits_full(self) -> List[Path]:
        """All circuits of the full graph respecting copy numbers
        (ref: multi_dbg.rs:565-620); used for to_styled_seqs."""
        remaining = [self.copy_num(e) for e in range(self.n_edges_full())]
        terminal = self.terminal_node_full()
        paths = []

        def node_remaining(v):
            return sum(remaining[e] for e, _c, _w in self.full.childs(v))

        def pick_node():
            if terminal is not None and node_remaining(terminal) > 0:
                return terminal
            for v in range(self.n_nodes_full()):
                if node_remaining(v) > 0:
                    return v
            return None

        def pick_child(v):
            best = None
            for e, c, w in sorted(self.full.childs(v), key=lambda x: x[2].base):
                if remaining[e] > 0:
                    return e, c
            return None

        while True:
            start = pick_node()
            if start is None:
                break
            path = []
            node = start
            while True:
                pc = pick_child(node)
                if pc is None:
                    break
                e, child = pc
                path.append(e)
                remaining[e] -= 1
                node = child
                if node == start:
                    break
            assert node == start, "found path was not an euler circuit"
            paths.append(path)
        return paths

    def to_styled_seqs(self) -> List[StyledSequence]:
        """Recover genome-like styled sequences from copy numbers."""
        terminal = self.terminal_node_full()
        out = []
        for path in self.get_euler_circuits_full():
            bases = bytes(self.base(e) for e in path)
            passes_terminal = terminal is not None and any(
                self.full.edge_targets[e] == terminal for e in path
            )
            if passes_terminal:
                # split at terminal positions into linear haplotypes
                seq = bytearray()
                for e in path:
                    seq.append(self.base(e))
                    if self.full.edge_targets[e] == terminal:
                        trimmed = bytes(b for b in seq if b != NULL_BASE)
                        if trimmed:
                            out.append(StyledSequence.linear(trimmed))
                        seq = bytearray()
                trimmed = bytes(b for b in seq if b != NULL_BASE)
                if trimmed:
                    out.append(StyledSequence.linear(trimmed))
            else:
                out.append(StyledSequence.circular(bases))
        return out

    # -- scoring helpers ------------------------------------------------------

    def n_euler_circuits_log(self) -> float:
        """log #Eulerian circuits of the compact multigraph
        (ref: multi_dbg.rs:831-836 n_euler_circuits — the reference passes
        allow_multiple_component=false: a positive subgraph split into
        several SCCs has NO Eulerian circuit, so the assignment scores
        -inf)."""
        return euler_circuit_count(
            self.compact, self.get_copy_nums(), allow_multiple_component=False
        )

    # -- equality -------------------------------------------------------------

    def is_equivalent(self, other: "MultiDbg") -> bool:
        return (
            self.k == other.k
            and self.n_nodes_full() == other.n_nodes_full()
            and self.n_edges_full() == other.n_edges_full()
            and self.n_nodes_compact() == other.n_nodes_compact()
            and self.n_edges_compact() == other.n_edges_compact()
            and self.genome_size() == other.genome_size()
        )

    def __repr__(self) -> str:
        return (
            f"MultiDbg(k={self.k}, full={self.n_nodes_full()}n/{self.n_edges_full()}e, "
            f"compact={self.n_nodes_compact()}n/{self.n_edges_compact()}e, "
            f"genome_size={self.genome_size()})"
        )


class KmerNotFoundError(Exception):
    def __init__(self, kmers):
        self.kmers = kmers
        super().__init__(f"{len(kmers)} k-mers not found in DBG")


# -- array-resident k+1 extension (ref: multi_dbg.rs:1177-1206,1685-1746) ------
#
# The unambiguous-extension jump runs up to thousands of k+1 stages; building
# Python DiGraph objects per stage costs 0.3-0.5s each at production sizes.
# These helpers keep the full graph as numpy arrays across the whole jump.


from typing import NamedTuple


class FullArrays(NamedTuple):
    """Full-graph snapshot: edge list arrays + the terminal node id.
    Node ids are 0..n_nodes-1; the terminal (if any) is explicit."""

    n_nodes: int
    terminal: Optional[int]
    srcs: np.ndarray  # int64 [E]
    tgts: np.ndarray  # int64 [E]
    copy: np.ndarray  # int64 [E]
    bases: np.ndarray  # int64 [E]


def _copy_nums_valid_arrays(fa: FullArrays) -> bool:
    """Vectorized flow-consistency check (ref: multi_dbg.rs:1008)."""
    cin = np.bincount(fa.tgts, weights=fa.copy, minlength=fa.n_nodes)
    cout = np.bincount(fa.srcs, weights=fa.copy, minlength=fa.n_nodes)
    return bool(np.array_equal(cin, cout))


def _n_ambiguous_arrays(fa: FullArrays) -> int:
    """Vectorized count of nodes with in-deg > 1 AND out-deg > 1 over
    positive-copy edges (matches MultiDbg.n_ambiguous_node)."""
    pos = fa.copy > 0
    ind = np.bincount(fa.tgts[pos], minlength=fa.n_nodes)
    outd = np.bincount(fa.srcs[pos], minlength=fa.n_nodes)
    return int(((ind > 1) & (outd > 1)).sum())


def _kp1_arrays(fa: FullArrays) -> FullArrays:
    """One k+1 stage on the array representation: edge of G -> node of G'
    (same index), (in,out) cartesian pairs at non-terminal nodes -> edges of
    G', terminal re-inserted.  Index order identical to
    ``to_node_centric_graph`` (per-node blocks ascending, terminal block
    spliced at the terminal's position)."""
    n_v, n_e = fa.n_nodes, len(fa.srcs)
    srcs, tgts, copy, bases, terminal = (
        fa.srcs, fa.tgts, fa.copy, fa.bases, fa.terminal,
    )

    in_deg = np.bincount(tgts, minlength=n_v)
    out_deg = np.bincount(srcs, minlength=n_v)
    # edges grouped by node ascending, within a group index-ascending —
    # exactly the _in/_out adjacency list order
    order_in = np.argsort(tgts, kind="stable")
    order_out = np.argsort(srcs, kind="stable")
    out_starts = np.zeros(n_v + 1, dtype=np.int64)
    np.cumsum(out_deg, out=out_starts[1:])

    # (e_in, e_out) cartesian pairs per non-terminal node, e_in-major
    mask_in = (
        np.ones(n_e, dtype=bool)
        if terminal is None else tgts[order_in] != terminal
    )
    ein_src = order_in[mask_in]  # in-edges of non-terminal nodes, in order
    v_of = tgts[ein_src]
    reps = out_deg[v_of]
    e1 = np.repeat(ein_src, reps)
    total = int(reps.sum())
    offs = np.zeros(len(ein_src) + 1, dtype=np.int64)
    np.cumsum(reps, out=offs[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], reps)
    e2 = order_out[out_starts[np.repeat(v_of, reps)] + within]

    # copy numbers: trivial when the shared node has degree 1 on either
    # side; guess_copy_num for the (rare) ambiguous nodes
    vmid = tgts[e1]
    new_copy = np.where(
        in_deg[vmid] == 1, copy[e2],
        np.where(out_deg[vmid] == 1, copy[e1], -1),
    )
    amb = np.flatnonzero(new_copy < 0)
    if amb.size:
        in_starts = np.zeros(n_v + 1, dtype=np.int64)
        np.cumsum(in_deg, out=in_starts[1:])
        for v in np.unique(vmid[amb]):
            ins = order_in[in_starts[v] : in_starts[v + 1]]
            outs = order_out[out_starts[v] : out_starts[v + 1]]
            tab = MultiDbg.guess_copy_num(
                [int(copy[e]) for e in ins], [int(copy[e]) for e in outs]
            )
            pos_in = {int(e): i for i, e in enumerate(ins)}
            pos_out = {int(e): i for i, e in enumerate(outs)}
            sel = amb[vmid[amb] == v]
            for idx in sel:
                new_copy[idx] = tab[pos_in[int(e1[idx])]][pos_out[int(e2[idx])]]
    new_base = bases[e2]

    # assemble: nodes 0..n_e-1 = old edges, then the terminal node; edge
    # blocks per node ascending with the terminal block spliced at the
    # terminal node's position (matches the loop construction)
    if terminal is not None:
        t_new = n_e
        split = int(np.searchsorted(vmid, terminal))
        t_in = order_in[tgts[order_in] == terminal]
        t_out = order_out[srcs[order_out] == terminal]
        new_srcs = np.concatenate([
            e1[:split], t_in,
            np.full(len(t_out), t_new, dtype=np.int64), e1[split:],
        ])
        new_tgts = np.concatenate([
            e2[:split], np.full(len(t_in), t_new, dtype=np.int64),
            t_out, e2[split:],
        ])
        new_cp = np.concatenate([
            new_copy[:split], copy[t_in], copy[t_out], new_copy[split:],
        ])
        new_bs = np.concatenate([
            new_base[:split], bases[t_in], bases[t_out], new_base[split:],
        ])
        return FullArrays(n_e + 1, t_new, new_srcs, new_tgts, new_cp, new_bs)
    return FullArrays(n_e, None, e1, e2, new_copy, new_base)


def _paths_kp1_arrays(fa_new: FullArrays, paths: List[Optional[Path]]):
    """Vectorized path upconversion on the k+1 arrays (semantics of
    ``path_kp1_from_path_k``, ref: multi_dbg.rs:1248-1292): linear form
    [terminal->first, steps..., last->terminal] when both terminal edges
    exist, else circular with wraparound."""
    nv = fa_new.n_nodes
    keys = fa_new.srcs * nv + fa_new.tgts
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]

    def lookup(qs: np.ndarray, qt: np.ndarray):
        q = qs * nv + qt
        pos = np.searchsorted(skeys, q)
        pos_c = np.minimum(pos, len(skeys) - 1)
        ok = (pos < len(skeys)) & (skeys[pos_c] == q)
        return np.where(ok, order[pos_c], -1), ok

    out: List[Optional[Path]] = []
    t = fa_new.terminal
    for p in paths:
        if p is None:
            out.append(None)
            continue
        pa = np.asarray(p, dtype=np.int64)
        n = len(pa)
        start = end = None
        if t is not None:
            s_arr, s_ok = lookup(np.array([t, pa[-1]]), np.array([pa[0], t]))
            if s_ok.all():
                start, end = int(s_arr[0]), int(s_arr[1])
        if start is not None:
            inner, ok = lookup(pa[:-1], pa[1:])
            assert ok.all(), "invalid path"
            out.append([start] + inner.tolist() + [end])
        else:
            nxt = np.roll(pa, -1)
            es, ok = lookup(pa, nxt)
            assert ok.all(), "invalid path"
            out.append(es.tolist())
    return out


def _in_csr(fa: FullArrays):
    """In-edge CSR of a FullArrays graph: (sorted edge ids by target,
    starts, degrees) — in-edges of v are sorted[starts[v]:starts[v+1]],
    ascending edge index (the _in adjacency order)."""
    order_in = np.argsort(fa.tgts, kind="stable")
    in_deg = np.bincount(fa.tgts, minlength=fa.n_nodes)
    starts = np.zeros(fa.n_nodes + 1, dtype=np.int64)
    np.cumsum(in_deg, out=starts[1:])
    return order_in, starts, in_deg


def _hint_kp1_array(
    hint: np.ndarray, order_in: np.ndarray, starts: np.ndarray,
    in_deg: np.ndarray,
) -> np.ndarray:
    """Vectorized mapping upconversion on one read's padded hint array
    [L, A] (-1 pad): node v (= k full edge = k+1 full node) expands to all
    in-edges of v in the k+1 graph (semantics of ``hint_kp1_from_hint_k``,
    ref: multi_dbg.rs:1325-1334)."""
    L, A = hint.shape
    v = hint.ravel().astype(np.int64)
    valid = v >= 0
    deg = np.where(valid, in_deg[np.where(valid, v, 0)], 0).astype(np.int64)
    csum = np.cumsum(deg) - deg  # exclusive prefix over flattened elements
    row_base = csum[np.arange(L) * A]  # cumsum at each row's first element
    row_counts = csum[np.arange(L) * A + (A - 1)] + deg[np.arange(L) * A + (A - 1)] - row_base
    W = max(1, int(row_counts.max(initial=1)))
    total = int(deg.sum())
    out = np.full((L, W), -1, dtype=np.int32)
    if total == 0:
        return out
    elem_of = np.repeat(np.arange(L * A, dtype=np.int64), deg)
    within = np.arange(total, dtype=np.int64) - np.repeat(csum, deg)
    vals = order_in[starts[v[elem_of]] + within]
    rows = elem_of // A
    cols = csum[elem_of] - row_base[rows] + within
    out[rows, cols] = vals
    return out
