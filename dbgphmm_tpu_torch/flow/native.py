"""ctypes binding to the native C++ flow solver (csrc/host/flow.cpp).

Builds ``csrc/host/flow.cpp`` with g++ on first use into the port's
``build/`` directory (``ops/_build.py``); falls back to the pure-Python
solver if the toolchain or build is unavailable.  Same contract as
:func:`dbgphmm_tpu_torch.flow.mincost.min_cost_flow_convex`.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Optional

import numpy as np

from ..graph.digraph import DiGraph
from .mincost import FlowEdge

_LIB = None
_LIB_TRIED = False

#: return code of the most recent native solve: 0 ok, 1 infeasible,
#: 2 repair-phase timeout (budget via DBGPHMM_FLOW_BUDGET_S).  Lets callers
#: distinguish "no feasible flow exists" from "solver gave up" and degrade
#: (e.g. keep previous copy nums) instead of aborting.
LAST_RC = 0


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        from ..ops import _build

        lib = ctypes.CDLL(str(_build.host_so("flow")))
        lib.dbg_min_cost_flow_convex.restype = ctypes.c_int
        lib.dbg_min_cost_flow_convex.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
        ]
        _LIB = lib
    except Exception as e:  # pragma: no cover - toolchain issues
        print(f"[flow.native] build/load failed, using Python solver: {e}",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _edge_cost_spec(w: FlowEdge):
    """Map a FlowEdge to (cost_type, coeff, freqs). Recognizes the closures
    produced by dbgphmm_tpu.multi_dbg.draft's error metrics via attributes;
    generic callables fall back to None (Python solver)."""
    if w.convex_cost is None:
        return 0, float(w.cost), []
    fn = w.convex_cost
    meta = getattr(fn, "_native_spec", None)
    if meta is not None:
        return meta
    return None


def min_cost_flow_convex_native(net: DiGraph) -> Optional[List[int]]:
    """Native solve; returns None if infeasible. Raises RuntimeError if any
    edge cost cannot be represented natively (caller should fall back)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native flow library unavailable")

    m = net.n_edges()
    src = np.asarray(net.edge_sources, dtype=np.int32)
    dst = np.asarray(net.edge_targets, dtype=np.int32)
    demand = np.empty(m, dtype=np.int64)
    capacity = np.empty(m, dtype=np.int64)
    cost_type = np.empty(m, dtype=np.int32)
    coeff = np.zeros(m, dtype=np.float64)
    freq_chunks = []
    offsets = np.zeros(m + 1, dtype=np.int64)
    for e in range(m):
        w: FlowEdge = net.edge_weights[e]
        spec = _edge_cost_spec(w)
        if spec is None:
            raise RuntimeError("edge cost not representable natively")
        ct, cf, fr = spec
        demand[e] = w.demand
        capacity[e] = w.capacity
        cost_type[e] = ct
        coeff[e] = cf
        freq_chunks.append(np.asarray(fr, dtype=np.float64))
        offsets[e + 1] = offsets[e] + len(fr)
    freqs_flat = (
        np.concatenate(freq_chunks) if offsets[-1] > 0 else np.zeros(1)
    )
    out = np.zeros(m, dtype=np.int64)
    rc = lib.dbg_min_cost_flow_convex(
        net.n_nodes(), m, src, dst, demand, capacity, cost_type, coeff,
        freqs_flat, offsets, out,
    )
    global LAST_RC
    LAST_RC = rc
    if rc != 0:
        return None
    return out.tolist()


def solve(net: DiGraph) -> Optional[List[int]]:
    """Native if possible, else the Python reference solver."""
    try:
        return min_cost_flow_convex_native(net)
    except RuntimeError:
        from .mincost import min_cost_flow_convex

        return min_cost_flow_convex(net)
