"""PHMM model as flat arrays ready for device kernels.

Counterpart of the reference's ``PHMMModel<N, E>`` graph-of-structs
(ref: src/hmmv2/common.rs:59-183), redesigned TPU-first: instead of iterating
petgraph adjacency per node, the transition structure is materialized as a
padded dense gather table ``[n_nodes, max_deg]`` of parent/child indices and
log transition probabilities.  Degree is bounded (5 in the DBG case,
ref: multi_dbg.rs:82 MAX_DEGREE), so the "sparse matvec" of the forward step
becomes a fixed-shape gather + logsumexp — ideal for XLA/Pallas.

Base encoding: A=0 C=1 G=2 T=3, null 'n'=4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..prob import NEG_INF
from ..seq.collection import NULL_BASE
from ..graph.digraph import DiGraph
from .params import PHMMParams

BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    BASE_TO_CODE[b] = i
BASE_TO_CODE[NULL_BASE] = 4
CODE_TO_BASE = np.frombuffer(b"ACGTn", dtype=np.uint8)


def encode_bases(seq: bytes) -> np.ndarray:
    """bytes -> uint8 codes (A=0..T=3, n=4)."""
    arr = BASE_TO_CODE[np.frombuffer(bytes(seq), dtype=np.uint8)]
    if np.any(arr == 255):
        raise ValueError("invalid base in sequence")
    return arr


@dataclass
class PHMMModel:
    """Array-form PHMM over a sequence graph.

    * ``emission[n]``     -- uint8 base code per node (4 = silent/terminal)
    * ``init_logp[n]``    -- log initial prob (Begin -> Match_v)
    * ``parent_idx[n,D]`` / ``parent_logt[n,D]`` -- padded in-adjacency
    * ``child_idx[n,D]``  / ``child_logt[n,D]``  -- padded out-adjacency

    Padding entries point at node 0 with -inf log prob, so gathers stay
    in-bounds and padded terms vanish in logsumexp.
    """

    params: PHMMParams
    emission: np.ndarray
    init_logp: np.ndarray
    parent_idx: np.ndarray
    parent_logt: np.ndarray
    child_idx: np.ndarray
    child_logt: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.emission.shape[0]

    @property
    def max_deg(self) -> int:
        return self.parent_idx.shape[1]

    def is_emittable(self) -> np.ndarray:
        return self.emission < 4


def seq_graph_to_phmm(
    graph: DiGraph,
    params: PHMMParams,
    mode: str = "normal",
    min_deg: int = 2,
) -> PHMMModel:
    """Convert a sequence graph to PHMM arrays.

    ``graph`` nodes carry ``(base: int byte, copy_num: int)`` tuples; edges
    carry ``copy_num: Optional[int]``.  ``mode`` selects the parameterization
    (ref: src/graph/seq_graph.rs:160-273):

    * ``"normal"``   -- init = c(v)/sum c, trans = c(target)/sum c(childs)
                         (edge copy numbers used when assigned)
    * ``"uniform"``  -- equal probs over emittable nodes/childs
    * ``"non_zero"`` -- like normal but node copy numbers clamped to >= 1
    """
    n = graph.n_nodes()
    emission = np.empty(n, dtype=np.uint8)
    copy_num = np.zeros(n, dtype=np.int64)
    for v, w in graph.nodes():
        base, c = w
        emission[v] = BASE_TO_CODE[base]
        copy_num[v] = c
    emittable = emission < 4

    min_copy = 1 if mode == "non_zero" else 0
    eff_copy = np.where(emittable, np.maximum(copy_num, min_copy), 0)

    init_logp = np.full(n, NEG_INF)
    if mode == "uniform":
        n_emit = int(emittable.sum())
        if n_emit:
            init_logp[emittable] = -np.log(n_emit)
    else:
        total = eff_copy.sum()
        pos = emittable & (eff_copy > 0)
        if total > 0:
            init_logp[pos] = np.log(eff_copy[pos]) - np.log(total)

    # trans probs per edge
    edge_logt = np.full(graph.n_edges(), NEG_INF)
    if mode == "uniform":
        for v in range(n):
            childs = graph.childs(v)
            n_emit_childs = sum(1 for _e, w, _ew in childs if emittable[w])
            for e, w, _ew in childs:
                if emittable[w] and n_emit_childs > 0:
                    edge_logt[e] = -np.log(n_emit_childs)
    else:
        for v in range(n):
            childs = graph.childs(v)
            has_edge_copy = all(ew is not None for _e, _w, ew in childs) and childs
            if has_edge_copy:
                # ref: seq_graph.rs:184-197 edge copy numbers assigned
                parent_copy = copy_num[v]
                for e, w, ew in childs:
                    if emittable[w] and ew > 0 and parent_copy > 0:
                        edge_logt[e] = np.log(ew) - np.log(parent_copy)
            else:
                total_child = sum(
                    int(eff_copy[w]) for _e, w, _ew in childs if emittable[w]
                )
                for e, w, _ew in childs:
                    if emittable[w] and total_child > 0 and eff_copy[w] > 0:
                        edge_logt[e] = np.log(eff_copy[w]) - np.log(total_child)

    return _adjacency_arrays(graph, params, emission, init_logp, edge_logt, min_deg)


def _adjacency_arrays(
    graph: DiGraph,
    params: PHMMParams,
    emission: np.ndarray,
    init_logp: np.ndarray,
    edge_logt: np.ndarray,
    min_deg: int = 2,
) -> PHMMModel:
    """Pack adjacency into padded [n, D] gather tables."""
    n = graph.n_nodes()
    max_deg = max(
        [min_deg]
        + [graph.in_degree(v) for v in range(n)]
        + [graph.out_degree(v) for v in range(n)]
    )
    parent_idx = np.zeros((n, max_deg), dtype=np.int32)
    parent_logt = np.full((n, max_deg), NEG_INF)
    child_idx = np.zeros((n, max_deg), dtype=np.int32)
    child_logt = np.full((n, max_deg), NEG_INF)
    for v in range(n):
        for j, (e, p, _w) in enumerate(graph.parents(v)):
            parent_idx[v, j] = p
            parent_logt[v, j] = edge_logt[e]
        for j, (e, c, _w) in enumerate(graph.childs(v)):
            child_idx[v, j] = c
            child_logt[v, j] = edge_logt[e]
    return PHMMModel(
        params=params,
        emission=emission,
        init_logp=init_logp,
        parent_idx=parent_idx,
        parent_logt=parent_logt,
        child_idx=child_idx,
        child_logt=child_logt,
    )


# -- mock constructors (ref: src/hmmv2/mocks.rs, src/graph/mocks.rs) ----------


def linear_seq_graph(seq: bytes) -> DiGraph:
    """Per-base chain graph with copy number 1 (ref: graph/mocks.rs mock_linear
    -> to_seq_graph)."""
    g = DiGraph()
    prev = None
    for b in seq:
        v = g.add_node((b, 1))
        if prev is not None:
            g.add_edge(prev, v, None)
        prev = v
    return g


def linear_phmm(seq: bytes, params: PHMMParams) -> PHMMModel:
    """10bp linear mock is ``linear_phmm(b"ATTCGATCGT", ...)``
    (ref: hmmv2/mocks.rs:27 mock_linear_phmm)."""
    return seq_graph_to_phmm(linear_seq_graph(seq), params)


def linear_random_phmm(length: int, seed: int, params: PHMMParams) -> PHMMModel:
    from ..seq.random_seq import generate

    return linear_phmm(generate(length, seed), params)
