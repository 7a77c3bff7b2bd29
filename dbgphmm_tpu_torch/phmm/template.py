"""Vectorized PHMM construction from copy-number candidates.

The posterior hill-climb evaluates dozens-to-hundreds of candidate
copy-number assignments per iteration; rebuilding the PHMM per candidate via
Python graph iteration (as ``MultiDbg.to_phmm`` does) costs O(n_edges) Python
per candidate.  ``PHMMTemplate`` precomputes the topology-dependent index
structure once per k, making each candidate's probability arrays a handful of
numpy vector ops (ref equivalent: to_phmm re-derivation per candidate in
posterior.rs:504-515 evaluate closure).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..prob import NEG_INF
from .model import PHMMModel
from .params import PHMMParams


@dataclass
class PHMMTemplate:
    """Fixed topology of the PHMM of a MultiDbg at one k."""

    params: PHMMParams
    emission: np.ndarray  # [n] uint8 codes
    emittable: np.ndarray  # [n] bool
    src_node: np.ndarray  # [n] int32: source (k-1)-mer node of each full edge
    full_to_compact: np.ndarray  # [n] int32
    parent_idx: np.ndarray  # [n, D]
    parent_exists: np.ndarray  # [n, D] bool
    child_idx: np.ndarray  # [n, D]
    child_exists: np.ndarray  # [n, D] bool
    n_nodes_graph: int  # number of (k-1)-mer nodes in full graph

    def model_for(self, copy_nums_compact, mode: str = "normal") -> PHMMModel:
        """Probability arrays for one copy-number assignment (vectorized)."""
        cn = np.asarray(copy_nums_compact, dtype=np.int64)
        copy = cn[self.full_to_compact]
        min_copy = 1 if mode == "non_zero" else 0
        eff = np.where(self.emittable, np.maximum(copy, min_copy), 0)

        n = eff.shape[0]
        with np.errstate(divide="ignore"):
            if mode == "uniform":
                n_emit = int(self.emittable.sum())
                init_logp = np.where(self.emittable, -np.log(max(n_emit, 1)), NEG_INF)
                # denominator: number of emittable childs per source node
                denom = np.zeros(self.n_nodes_graph, dtype=np.int64)
                np.add.at(denom, self.src_node[self.emittable], 1)
                val = np.where(
                    self.emittable & (denom[self.src_node] > 0),
                    -np.log(np.maximum(denom[self.src_node], 1)),
                    NEG_INF,
                )
            else:
                total = eff.sum()
                init_logp = np.where(
                    self.emittable & (eff > 0) & (total > 0),
                    np.log(np.maximum(eff, 1)) - np.log(max(total, 1)),
                    NEG_INF,
                )
                # denominator: sum of eff over emittable childs of each node
                denom = np.zeros(self.n_nodes_graph, dtype=np.int64)
                np.add.at(denom, self.src_node, eff)  # eff=0 for non-emittable
                d = denom[self.src_node]
                val = np.where(
                    self.emittable & (eff > 0) & (d > 0),
                    np.log(np.maximum(eff, 1)) - np.log(np.maximum(d, 1)),
                    NEG_INF,
                )

        # trans prob into edge e is val[e] regardless of which parent
        parent_logt = np.where(self.parent_exists, val[:, None], NEG_INF)
        child_logt = np.where(
            self.child_exists, val[self.child_idx], NEG_INF
        )
        return PHMMModel(
            params=self.params,
            emission=self.emission,
            init_logp=init_logp,
            parent_idx=self.parent_idx,
            parent_logt=parent_logt,
            child_idx=self.child_idx,
            child_logt=child_logt,
        )


def make_template(dbg, params: PHMMParams) -> PHMMTemplate:
    """Extract the fixed index structure from a MultiDbg (once per k)."""
    from ..phmm.model import BASE_TO_CODE

    n = dbg.n_edges_full()
    emission = np.empty(n, dtype=np.uint8)
    src_node = np.empty(n, dtype=np.int32)
    for e in range(n):
        emission[e] = BASE_TO_CODE[dbg.full.edge(e).base]
        src_node[e] = dbg.full.edge_sources[e]
    emittable = emission < 4

    full_to_compact = np.empty(n, dtype=np.int32)
    for ec in range(dbg.n_edges_compact()):
        for ef in dbg.edges_in_full(ec):
            full_to_compact[ef] = ec

    max_deg = 2
    for v in range(dbg.n_nodes_full()):
        if not dbg.full.node(v).is_terminal:
            max_deg = max(max_deg, dbg.full.in_degree(v), dbg.full.out_degree(v))
    # bucket the degree exactly like ops.forward.pad_model so that positions
    # precomputed from this template match degree-padded DeviceModels (a
    # D=3 template vs D=5 padded model crashes the mapped-pos kernel)
    max_deg = 2 if max_deg <= 2 else (5 if max_deg <= 5 else max_deg)
    parent_idx = np.zeros((n, max_deg), dtype=np.int32)
    parent_exists = np.zeros((n, max_deg), dtype=bool)
    child_idx = np.zeros((n, max_deg), dtype=np.int32)
    child_exists = np.zeros((n, max_deg), dtype=bool)
    for v in range(dbg.n_nodes_full()):
        if dbg.full.node(v).is_terminal:
            continue
        ins = dbg.full.in_edges(v)
        outs = dbg.full.out_edges(v)
        for e1 in ins:
            for j2, e2 in enumerate(outs):
                child_idx[e1, j2] = e2
                child_exists[e1, j2] = True
        for e2 in outs:
            for j1, e1 in enumerate(ins):
                parent_idx[e2, j1] = e1
                parent_exists[e2, j1] = True

    import dataclasses as _dc

    p2 = _dc.replace(params, n_warmup=dbg.k)
    return PHMMTemplate(
        params=p2,
        emission=emission,
        emittable=emittable,
        src_node=src_node,
        full_to_compact=full_to_compact,
        parent_idx=parent_idx,
        parent_exists=parent_exists,
        child_idx=child_idx,
        child_exists=child_exists,
        n_nodes_graph=dbg.n_nodes_full(),
    )
