"""Draft DBG construction + MSE copy-number fitting
(ref: src/multi_dbg/draft.rs, src/hashdbg.rs:481-573).

The copy-number estimation is a convex min-cost circulation: each compact
edge's cost is the squared error between its integer copy number and the
(coverage-normalized) k-mer count/mapping frequencies of its constituent
k-mers.  Error metrics V1/V2/V4 follow the reference exactly
(ref: draft.rs:70-123).
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Sequence, Tuple

from ..flow import FlowEdge, min_cost_flow_convex
from ..flow.native import solve as flow_solve
from ..graph.compact import compact_simple_paths
from ..graph.digraph import DiGraph
from ..graph.utils import split_node
from ..hashdbg import HashDbg
from ..kmer import has_null, is_null
from ..prob import kmer_coverage
from . import MultiDbg

# ref: draft.rs:130
MAX_COPY_NUM_OF_EDGE = 1000


# -- error metrics (ref: draft.rs:70-123) -------------------------------------


def v1_error(freqs: Sequence[float]) -> Callable[[int], float]:
    """h(c) = sum |c - f|^2"""

    def cost(c: int) -> float:
        return sum((c - f) ** 2 for f in freqs)

    cost._native_spec = (1, 0.0, list(freqs))
    return cost


def v2_error(freqs: Sequence[float]) -> Callable[[int], float]:
    """h(c) = sum |1 - c/(f+1e-7)|^2"""

    def cost(c: int) -> float:
        return sum((1.0 - c / (f + 1e-7)) ** 2 for f in freqs)

    cost._native_spec = (2, 0.0, list(freqs))
    return cost


def v4_error(freqs: Sequence[float]) -> Callable[[int], float]:
    """h(c) = sum |1 - c/(f+0.1)|^2 + |f/(c+0.1) - 1|^2"""

    def cost(c: int) -> float:
        return sum(
            (1.0 - c / (f + 1e-1)) ** 2 + (f / (c + 1e-1) - 1.0) ** 2 for f in freqs
        )

    cost._native_spec = (3, 0.0, list(freqs))
    return cost


ERROR_METRICS = {"V1": v1_error, "V2": v2_error, "V4": v4_error}


def mse_flow_edge(
    freqs: Sequence[float],
    fixed_copy_num: Optional[int],
    non_zero: bool,
    metric: str = "V1",
) -> FlowEdge:
    """ref: draft.rs:36-148 MinSquaredErrorCopyNumAndFreq + FlowEdge impl."""
    if fixed_copy_num is not None:
        demand = capacity = fixed_copy_num
    else:
        demand = 1 if non_zero else 0
        capacity = MAX_COPY_NUM_OF_EDGE
    return FlowEdge(
        demand=demand,
        capacity=capacity,
        convex_cost=ERROR_METRICS[metric](list(freqs)),
    )


# -- HashDbg MSE fit (ref: hashdbg.rs:481-573) --------------------------------


def hashdbg_to_mse_network(
    hd: HashDbg, coverage: float, n_haplotypes: Optional[int], metric: str = "V1"
) -> Tuple[DiGraph, List[List[bytes]]]:
    """Compact the count graph, build the flow network, split the terminal to
    fix haplotype count.  Returns (network, per-edge k-mer lists); the last
    network edge is the terminal bridge with no k-mers."""
    full = hd.to_graph(lambda km1: km1, lambda kmer: (kmer, hd.get(kmer)))
    cg, _nm = compact_simple_paths(full, is_target=lambda km1: not is_null(km1))

    net = cg.map(
        lambda _v, _w: None,
        lambda _e, path: mse_flow_edge(
            [
                count / coverage
                for _orig, (kmer, count) in path
                if not has_null(kmer)
            ],
            None,
            False,
            metric,
        ),
    )
    kmers: List[List[bytes]] = [
        [kmer for _orig, (kmer, _c) in cg.edge(e)] for e in range(cg.n_edges())
    ]

    terminal = next(
        (v for v in range(cg.n_nodes()) if is_null(cg.node(v))), None
    )
    assert terminal is not None, "graph has no terminal node"
    net = split_node(net, terminal, mse_flow_edge([], n_haplotypes, False, metric))
    kmers.append([])
    return net, kmers


def hashdbg_with_mse_copy_nums(
    hd: HashDbg, coverage: float, n_haplotypes: Optional[int]
) -> HashDbg:
    """(ref: hashdbg.rs:547-573)"""
    net, kmer_map = hashdbg_to_mse_network(hd, coverage, n_haplotypes, "V1")
    copy_nums = flow_solve(net)
    assert copy_nums is not None, "mse flow network cannot be solved"
    out: List[Tuple[bytes, int]] = []
    for e in range(net.n_edges()):
        for kmer in kmer_map[e]:
            out.append((kmer, copy_nums[e]))
    return HashDbg.from_kmers(hd.k, out)


# -- MultiDbg MSE re-fit from mapping freqs (ref: draft.rs:200-316) -----------


def mappings_to_freqs(dbg: MultiDbg, mappings) -> List[float]:
    """Expected usage of each full edge from read mappings
    (ref: draft.rs:200-213).  ``mappings``: per read, per base, list of
    (node == full edge index, prob)."""
    freqs = [0.0] * dbg.n_edges_full()
    for mapping in mappings:
        for per_base in mapping:
            for node, p in per_base:
                freqs[node] += p
    return freqs


def mse_network_from_freqs(
    dbg: MultiDbg,
    freqs: Sequence[float],
    coverage: float,
    terminal_count: str = "free",  # "free" | "fixed" | "disconnect"
    n_haplotypes: Optional[int] = None,
    not_make_new_zero_edge: bool = False,
    metric: str = "V4",
) -> DiGraph:
    """(ref: draft.rs:215-276)"""
    net = DiGraph()
    for _v, _w in dbg.compact.nodes():
        net.add_node(None)
    for e in range(dbg.n_edges_compact()):
        s, t = dbg.compact.edge_endpoints(e)
        fs = [
            freqs[ef] / coverage
            for ef in dbg.edges_in_full(e)
            if not dbg.full.edge(ef).is_null_base()
        ]
        copy_num = dbg.copy_num_of_edge_in_compact(e)
        non_zero = not_make_new_zero_edge and copy_num != 0
        net.add_edge(s, t, mse_flow_edge(fs, None, non_zero, metric))

    terminal = dbg.terminal_node_compact()
    if terminal_count == "fixed":
        assert terminal is not None
        net = split_node(net, terminal, mse_flow_edge([], n_haplotypes, False, metric))
    elif terminal_count == "disconnect":
        if terminal is not None:
            net = split_node(net, terminal, None)
    return net


def min_squared_error_copy_nums_from_freqs(
    dbg: MultiDbg,
    freqs: Sequence[float],
    coverage: float,
    n_haplotypes: Optional[int] = None,
    fallback_copy_nums: Optional[Sequence[int]] = None,
) -> List[int]:
    """(ref: draft.rs:280-316)

    ``fallback_copy_nums``: returned when the solver times out (native rc=2)
    even on the clamped retry — the MSE re-init is a heuristic restart, so
    keeping the previous assignment beats aborting the whole inference.
    """
    tc = "fixed" if n_haplotypes is not None else "free"
    net = mse_network_from_freqs(
        dbg, freqs, coverage, tc, n_haplotypes, False, "V4"
    )
    copy_nums = flow_solve(net)
    if copy_nums is None:
        # infeasible or solver gave up (pathological freqs; round 4): retry
        # once with freqs clamped to a sane per-node bound — expected node
        # usage cannot exceed a few visits per read
        import numpy as np

        f = np.asarray(freqs, dtype=float)
        cap = max(3.0 * coverage, 1.0) * 3.0
        print(f"[draft] mse flow solve failed; retrying with freqs clamped "
              f"to {cap:.1f} (max was {f.max(initial=0):.1f})")
        net = mse_network_from_freqs(
            dbg, np.minimum(f, cap), coverage, tc, n_haplotypes, False, "V4"
        )
        copy_nums = flow_solve(net)
    if copy_nums is None and fallback_copy_nums is not None:
        from ..flow import native as flow_native

        why = "timeout" if flow_native.LAST_RC == 2 else "infeasible"
        print(f"[draft] mse flow solve failed twice ({why}); keeping "
              f"previous copy nums")
        return list(fallback_copy_nums)
    assert copy_nums is not None, "mse flow network cannot be solved"
    return copy_nums[: dbg.n_edges_compact()]


# -- draft pipeline (ref: draft.rs:318-392) -----------------------------------


def create_draft_from_reads(
    k: int,
    reads,
    p_error: float,
    genome_size: int,
    n_haplotypes: Optional[int] = None,
    min_count: int = 2,
    min_deadend_count: int = 2,
    verbose: bool = True,
) -> MultiDbg:
    """Reads -> cleaned, copy-number-fitted k0 draft DBG
    (ref: draft.rs:322-368 create_draft_from_reads_v2)."""
    log = (lambda *a: print("[draft]", *a, file=sys.stderr)) if verbose else (lambda *a: None)
    hd = HashDbg.from_fragment_seqs(k, reads)
    log(f"raw kmers={hd.n()}")
    n_rare = hd.remove_rare_kmers(min_count)
    log(f"removed {n_rare} rare k-mers")
    n_dead = hd.remove_deadends(min_deadend_count)
    log(f"removed {n_dead} deadends")
    starts, ends = hd.augment_deadends()
    log(f"augmented deadends: {len(starts)} starts, {len(ends)} ends")
    hd = hd.largest_component()
    log(f"largest component kmers={hd.n()}")

    coverage = reads.coverage(genome_size)
    adjusted = kmer_coverage(k, reads.average_length(), coverage, p_error)
    log(f"coverage={coverage:.3f} adjusted={adjusted:.3f}")
    hd = hashdbg_with_mse_copy_nums(hd, adjusted, n_haplotypes)
    return MultiDbg.from_hashdbg(hd)


def create_draft_from_dataset(k: int, dataset, min_count: int = 2,
                              min_deadend_count: Optional[int] = None) -> MultiDbg:
    """(ref: draft.rs:371-392)"""
    if min_deadend_count is None:
        min_deadend_count = max(int(dataset.coverage() / 4.0), 1)
    return create_draft_from_reads(
        k,
        dataset.reads,
        dataset.params.p_error(),
        dataset.genome_size(),
        n_haplotypes=dataset.genome.n_linear_haplotypes(),
        min_count=min_count,
        min_deadend_count=min_deadend_count,
    )
