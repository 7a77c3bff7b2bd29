"""k-shortest paths and cycles (ref: src/graph/k_shortest.rs).

* :func:`k_shortest_cycle` — heap search with per-node visit cap (used for
  candidate cycle generation, ref: k_shortest.rs:61-110).
* :func:`k_shortest_simple_path` — Yen's algorithm with Dijkstra subroutine
  (ref: k_shortest.rs:119-210, which uses repeated A* with forbidden edges).
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Set, Tuple

from .digraph import DiGraph


def dijkstra_path(
    graph: DiGraph,
    source: int,
    target: int,
    edge_cost: Callable[[int], int],
    removed_nodes: Optional[Set[int]] = None,
    removed_edges: Optional[Set[int]] = None,
) -> Optional[Tuple[int, List[int]]]:
    """Shortest path source->target as (cost, edge list); None if unreachable.

    Costs must be non-negative. ``removed_*`` implement Yen's spur filtering.
    """
    removed_nodes = removed_nodes or set()
    removed_edges = removed_edges or set()
    if source in removed_nodes:
        return None
    dist = {source: 0}
    prev_edge = {}
    heap = [(0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if v == target:
            # reconstruct
            path = []
            while v != source:
                e = prev_edge[v]
                path.append(e)
                v = graph.edge_sources[e]
            path.reverse()
            return d, path
        if d > dist.get(v, float("inf")):
            continue
        for e, w, _ in graph.childs(v):
            if e in removed_edges or w in removed_nodes:
                continue
            nd = d + edge_cost(e)
            if nd < dist.get(w, float("inf")):
                dist[w] = nd
                prev_edge[w] = e
                heapq.heappush(heap, (nd, w))
    return None


_KLIB = None
_KLIB_TRIED = False


def _load_native():
    """Build/load the native Yen's kernel (csrc/host/kshortest.cpp, into the
    port's build directory); None if
    the toolchain is unavailable (pure-Python fallback below)."""
    global _KLIB, _KLIB_TRIED
    if _KLIB_TRIED:
        return _KLIB
    _KLIB_TRIED = True
    import ctypes

    import numpy as np

    from ..ops import _build

    try:
        lib = ctypes.CDLL(str(_build.host_so("kshortest")))
        lib.dbg_k_shortest_simple_paths.restype = ctypes.c_int32
        lib.dbg_k_shortest_simple_paths.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
        ]
        _KLIB = lib
    except Exception as e:  # pragma: no cover - toolchain issues
        import sys

        print(f"[k_shortest] native build failed, using Python: {e}",
              file=sys.stderr)
        _KLIB = None
    return _KLIB


def k_shortest_simple_path(
    graph: DiGraph,
    source: int,
    target: int,
    k: int,
    edge_cost: Callable[[int], int],
) -> List[List[int]]:
    """Yen's k shortest loopless paths (as edge lists).

    Uses the native kernel (cpp/kshortest.cpp, identical tie-breaking) when
    available — the rescue sweep runs hundreds of these per posterior
    iteration (ref: neighbors.rs:239-409)."""
    import numpy as np

    if isinstance(edge_cost, np.ndarray):
        cost_arr, edge_cost = edge_cost, edge_cost.__getitem__
    else:
        cost_arr = None
    lib = _load_native()
    if lib is not None:
        n_nodes, n_edges = graph.n_nodes(), graph.n_edges()
        src = np.asarray(graph.edge_sources, dtype=np.int32)
        dst = np.asarray(graph.edge_targets, dtype=np.int32)
        cost = (
            cost_arr.astype(np.int64, copy=False)
            if cost_arr is not None else np.fromiter(
                (edge_cost(e) for e in range(n_edges)), dtype=np.int64,
                count=n_edges,
            )
        )
        cap = max(16, k * (n_nodes + 1))
        out_edges = np.empty(cap, dtype=np.int32)
        out_off = np.zeros(k + 1, dtype=np.int32)
        n = lib.dbg_k_shortest_simple_paths(
            n_nodes, n_edges, src, dst, cost, source, target, k,
            out_edges, cap, out_off,
        )
        return [
            out_edges[out_off[i] : out_off[i + 1]].tolist() for i in range(n)
        ]
    first = dijkstra_path(graph, source, target, edge_cost)
    if first is None:
        return []
    paths: List[List[int]] = [first[1]]
    candidates: List[Tuple[int, List[int]]] = []
    seen_cands: Set[Tuple[int, ...]] = set()

    for _ in range(1, k):
        a = paths[-1]
        removed_nodes: Set[int] = set()
        for i in range(len(a)):
            spur_node = graph.edge_sources[a[i]]
            if spur_node in removed_nodes:
                break
            removed_edges: Set[int] = set()
            for p in paths:
                if len(p) > i and p[:i] == a[:i]:
                    removed_edges.add(p[i])
            res = dijkstra_path(
                graph, spur_node, target, edge_cost,
                removed_nodes=removed_nodes, removed_edges=removed_edges,
            )
            if res is not None:
                _, spur_path = res
                cand = a[:i] + spur_path
                key = tuple(cand)
                if key not in seen_cands:
                    seen_cands.add(key)
                    cost = sum(edge_cost(e) for e in cand)
                    heapq.heappush(candidates, (cost, cand))
            removed_nodes.add(spur_node)
        if not candidates:
            break
        _, best = heapq.heappop(candidates)
        paths.append(best)
    return paths


def k_shortest_cycle(
    graph: DiGraph,
    edge: int,
    k: int,
    edge_cost: Callable[[int], int],
    is_joinable: Optional[Callable[[List[int], int], bool]] = None,
) -> List[List[int]]:
    """1st..k-th shortest cycles that start with ``edge``
    (ref: k_shortest.rs:61-110): heap of partial paths, a node may be settled
    at most k times."""
    if is_joinable is None:
        is_joinable = lambda _path, _e: True
    count = [0] * graph.n_nodes()
    source = graph.edge_sources[edge]
    heap: List[Tuple[int, int, List[int]]] = [(edge_cost(edge), 0, [edge])]
    cycles: List[List[int]] = []
    uid = 1
    while heap:
        score, _, path = heapq.heappop(heap)
        u = graph.edge_targets[path[-1]]
        count[u] += 1
        if u == source and count[u] <= k:
            cycles.append(path)
        if count[u] <= k:
            for e, _w, _ in graph.childs(u):
                if is_joinable(path, e):
                    heapq.heappush(heap, (score + edge_cost(e), uid, path + [e]))
                    uid += 1
    return cycles
