"""Neighbor copy-number generation for posterior sampling
(ref: src/multi_dbg/neighbors.rs).

Neighbors of a copy-number assignment X are flows reachable by one residual
cycle:

* **short**: all cycles of bounded size/flips on the +-1 capacity band
* **long**: min-weight cycle forcing each 0x edge up to 1x
* **reducer**: down-only cycles on copy > 2 edges
* **rescue**: k-shortest cycles through each 0x edge in the V4-MSE residual
  graph, weighted by length or k-mer count (the workhorse during extension)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from typing import List, Optional, Tuple

from ..flow import (
    DOWN,
    UP,
    FlowEdge,
    enumerate_neighboring_flows,
    find_neighboring_flow_by_edge_change,
    flow_to_residue_convex,
    is_edge_simple,
    residue_graph_cycle_to_flow,
    update_cycle_to_str,
)
from ..graph.digraph import DiGraph
from ..graph.k_shortest import k_shortest_simple_path
from ..tracing import count, span, timer
from . import MultiDbg
from .draft import mse_network_from_freqs

UpdateCycle = List[Tuple[int, str]]


@dataclass
class NeighborConfig:
    """(ref: neighbors.rs:32-50)

    The rescue_* fields configure the rescue-cycle search; the reference
    hardcodes these at the call site (posterior.rs:349 — 5, 20, true, 4,
    true), we expose them here with the same defaults.
    """

    max_cycle_size: int = 10
    max_flip: int = 2
    use_long_cycles: bool = True
    ignore_cycles_passing_terminal: bool = True
    use_reducers: bool = True
    rescue_k_non_zero: int = 5
    rescue_k_zero: int = 20
    rescue_weighted_by_copy_num: bool = True
    rescue_k_total: int = 4
    rescue_sort_by_freq: bool = True


@dataclass
class UpdateInfo:
    """(ref: neighbors.rs:55-187) — method tag + applied cycles, with the
    ``[e5+e2-,...]`` string round-trip used by INSPECT files."""

    cycles: List[UpdateCycle]
    method: str  # "rescue" | "multi_move" | "short" | "long" | "reducer" | "manual"
    meta: dict = field(default_factory=dict)

    def cycle(self) -> UpdateCycle:
        return self.cycles[0] if self.cycles else []

    def __str__(self) -> str:
        body = ",".join(update_cycle_to_str(c) for c in self.cycles)
        return f"{self.method}([{body}])"


def to_flow_network(dbg: MultiDbg) -> DiGraph:
    """+-1 band around current copy numbers (ref: neighbors.rs:219-230)."""
    net = DiGraph()
    for _v, _w in dbg.compact.nodes():
        net.add_node(None)
    for e in range(dbg.n_edges_compact()):
        s, t = dbg.compact.edge_endpoints(e)
        c = dbg.copy_num_of_edge_in_compact(e)
        net.add_edge(s, t, FlowEdge(max(c - 1, 0), c + 1, 0.0))
    return net


def is_passing_terminal(dbg: MultiDbg, cycle: UpdateCycle) -> bool:
    """(ref: neighbors.rs:480-491)"""
    t = dbg.terminal_node_compact()
    if t is None:
        return False
    for e, _d in cycle:
        s, tt = dbg.compact.edge_endpoints(e)
        if s == t or tt == t:
            return True
    return False


def to_short_neighbors(
    dbg: MultiDbg, max_cycle_size: int, max_flip: int
) -> List[Tuple[List[int], UpdateInfo]]:
    """(ref: neighbors.rs:413-427)"""
    with span("neighbors.network"):
        net = to_flow_network(dbg)
        copy_nums = dbg.get_copy_nums()
    out = []
    with timer("neighbors_cycles_s"):
        for flow, cycle in enumerate_neighboring_flows(
            net, copy_nums, max_cycle_size, max_flip
        ):
            out.append((flow, UpdateInfo([cycle], "short")))
    return out


def to_long_neighbors(dbg: MultiDbg) -> List[Tuple[List[int], UpdateInfo]]:
    """0x -> 1x via min-weight residual cycle (ref: neighbors.rs:431-453)."""
    with span("neighbors.network"):
        net = to_flow_network(dbg)
        copy_nums = dbg.get_copy_nums()
    out = []
    with timer("neighbors_paths_s"):
        for e in range(dbg.n_edges_compact()):
            if dbg.copy_num_of_edge_in_compact(e) != 0:
                continue
            res = find_neighboring_flow_by_edge_change(
                net,
                copy_nums,
                e,
                UP,
                lambda ec: dbg.n_bases(ec)
                // (dbg.copy_num_of_edge_in_compact(ec) + 1),
            )
            if res is None:
                continue
            flow, cycle = res
            if is_passing_terminal(dbg, cycle):
                continue
            out.append((flow, UpdateInfo([cycle], "long")))
    return out


def to_reducer_neighbors(dbg: MultiDbg) -> List[Tuple[List[int], UpdateInfo]]:
    """Down-only cycles on copy>2 edges (ref: neighbors.rs:455-478)."""
    with span("neighbors.network"):
        net = DiGraph()
        for _v, _w in dbg.compact.nodes():
            net.add_node(None)
        for e in range(dbg.n_edges_compact()):
            s, t = dbg.compact.edge_endpoints(e)
            c = dbg.copy_num_of_edge_in_compact(e)
            if c > 2:
                net.add_edge(s, t, FlowEdge(c - 1, c, 0.0))
            else:
                net.add_edge(s, t, FlowEdge(c, c, 0.0))
        copy_nums = dbg.get_copy_nums()
    out = []
    with timer("neighbors_cycles_s"):
        for flow, cycle in enumerate_neighboring_flows(net, copy_nums, 100, 0):
            out.append((flow, UpdateInfo([cycle], "reducer")))
    return out


def to_neighbor_copy_nums_and_infos(
    dbg: MultiDbg, config: NeighborConfig
) -> List[Tuple[List[int], UpdateInfo]]:
    """(ref: neighbors.rs:193-216)"""
    out = to_short_neighbors(dbg, config.max_cycle_size, config.max_flip)
    if config.use_long_cycles:
        out.extend(to_long_neighbors(dbg))
    if config.use_reducers:
        out.extend(to_reducer_neighbors(dbg))
    return out


def to_rescue_neighbors(
    dbg: MultiDbg,
    node_freqs: List[float],
    coverage: float,
    k_non_zero: int = 5,
    k_zero: int = 20,
    weighted_by_copy_num: bool = True,
    k_total: int = 4,
    sort_by_freq: bool = True,
) -> List[Tuple[List[int], UpdateInfo]]:
    """For each 0x compact edge, find the best up-cycles through it in the
    V4-MSE residual graph (ref: neighbors.rs:239-409).

    The MSE network and its residual graph depend only on the
    ``not_make_new_zero_edge`` flag, not on the rescued edge — they are
    built ONCE per sweep and shared across all zero edges (the reference
    rebuilds per edge but fans out with rayon, neighbors.rs:255-269; at
    production compact sizes the serial per-edge rebuild cost 46 s/sweep).

    The networks' build is the span ``neighbors.network``; each edge's
    k-shortest paths, and their conversion to flows and ranking, add to
    the timers ``neighbors_paths_s`` and ``neighbors_cycles_s``."""
    with span("neighbors.network"):
        zero_edges = [
            e for e in range(dbg.n_edges_compact())
            if dbg.copy_num_of_edge_in_compact(e) == 0
        ]
        count("zero_edges", len(zero_edges))
        if not zero_edges:
            return []
        copy_nums = dbg.get_copy_nums()
        ctx = {}
        for nz in (True, False):
            net = mse_network_from_freqs(
                dbg, node_freqs, coverage,
                terminal_count="disconnect",
                not_make_new_zero_edge=nz,
                metric="V4",
            )
            # the disconnect-split may have added nodes but adds no edges, so
            # the flow vector over original compact edges matches the network
            rg = flow_to_residue_convex(net, copy_nums)
            forced_of = {}
            for re_idx, _s, _t, r in rg.edges():
                if r.direction == UP and r.target not in forced_of:
                    forced_of[r.target] = re_idx
            # per-residual-edge base costs, shared by every zero edge (the
            # forced edge's BIG is patched in per query)
            targets = np.fromiter(
                (r.target for _e, _s, _t, r in rg.edges()),
                dtype=np.int64, count=rg.n_edges(),
            )
            n_bases = np.fromiter(
                (dbg.n_bases(int(t)) for t in targets), dtype=np.int64,
                count=len(targets),
            )
            copies = np.fromiter(
                (max(dbg.copy_num_of_edge_in_compact(int(t)), 1)
                 for t in targets), dtype=np.int64, count=len(targets),
            )
            len_cost = n_bases // copies
            freq_w = np.fromiter(
                (r.weight for _e, _s, _t, r in rg.edges()),
                dtype=np.float64, count=rg.n_edges(),
            )
            ctx[nz] = (rg, forced_of, len_cost, n_bases, freq_w)

    out = []
    for e in zero_edges:
        a = _rescue_for_edge(
            dbg, e, copy_nums, ctx[True], k_non_zero, True,
            weighted_by_copy_num,
        )
        b = _rescue_for_edge(
            dbg, e, copy_nums, ctx[False], k_zero, False,
            weighted_by_copy_num,
        )
        with timer("neighbors_cycles_s"):
            merged = a + b
            if sort_by_freq:
                merged.sort(key=lambda t: t[1].meta.get("freq", 0.0))
            out.extend(merged[:k_total])
    return out


def _rescue_for_edge(
    dbg, edge, copy_nums, ctx, k, not_make_new_zero_edge, weighted_by_copy_num
):
    """(ref: neighbors.rs:330-409)"""
    with timer("neighbors_paths_s"):
        rg, forced_of, len_cost, nk_cost, freq_w = ctx
        forced = forced_of.get(edge)
        if forced is None:
            return []
        v, w = rg.edge_endpoints(forced)

        BIG = 10**9
        base = len_cost if weighted_by_copy_num else nk_cost
        cost = base.copy()
        cost[forced] = BIG
        paths = k_shortest_simple_path(rg, w, v, k, cost)
    count("rescue_paths", len(paths))

    with timer("neighbors_cycles_s"):
        lw = len_cost.copy()
        nw = nk_cost.copy()
        lw[forced] = nw[forced] = BIG
        out = []
        for index, path in enumerate(paths):
            cycle = [forced] + path
            if not is_edge_simple(rg, cycle):
                continue
            new_flow, update = residue_graph_cycle_to_flow(copy_nums, rg,
                                                           cycle)
            cyc = np.asarray(cycle, dtype=np.int64)
            info = UpdateInfo(
                [update], "rescue",
                meta=dict(index=index, length=int(lw[cyc].sum()),
                          freq=float(freq_w[cyc].sum()),
                          n_kmers=int(nw[cyc].sum()),
                          non_zero=not_make_new_zero_edge),
            )
            out.append((new_flow, info))
    return out


# -- multi-move helpers (ref: neighbors.rs:493-524) ---------------------------


def is_independent_update(cycles: List[UpdateCycle], next_cycle: UpdateCycle) -> bool:
    used = {e for c in cycles for e, _d in c}
    return not any(e in used for e, _d in next_cycle)


def apply_update_cycle(copy_nums: List[int], cycle: UpdateCycle) -> None:
    for e, d in cycle:
        copy_nums[e] += 1 if d == UP else -1
