"""Everything the benchmark touches of the system under test, the PyTorch
and CUDA port ``dbgphmm_tpu_torch``.

A traffic file's ``entry`` names the file ``perfbench/entries/<entry>.py``
that drives one unit of its traffic (its ``Entry``, a subclass of
:class:`Entry`) and compares what the unit produced (its ``numbers``).

Each unit starts from the same draft (the program copies it before it
changes it) and maps its own read set.  What a unit produced is captured
as it stands, with its reads, and turned into plain arrays only after the
measured window (:func:`graph_of`).

In a traced run the benchmark records its own spans around the program's
layer calls (``SPANS``: module attributes wrapped for the run and restored
after) and, for each kernel whose work ``perfbench/roofline/`` counts, the
inputs of its launches (``LaunchRecorder``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .reference.graph import Graph

PACKAGE = "dbgphmm_tpu_torch"

# span name -> program functions, as looked up by the module that calls
# them (the benchmark wraps the name in that module)
SPANS = {
    "seed": [("multi_dbg.posterior", "seed_mappings_arrays")],
    "decode": [("multi_dbg.posterior", "mappings_sparse_adaptive"),
               ("multi_dbg.posterior", "node_freqs_and_mappings")],
    "refine": [("multi_dbg.posterior", "mappings_refine")],
    "scorer_setup": [("multi_dbg.posterior", "make_template"),
                     ("multi_dbg.posterior", "precompute_positions"),
                     ("multi_dbg.posterior", "make_scorer")],
    "score": [("multi_dbg.posterior", "score_candidates")],
    "climb": [("multi_dbg.posterior", "to_rescue_neighbors"),
              ("multi_dbg.posterior", "to_neighbor_copy_nums_and_infos")],
    "extend": [("multi_dbg.posterior", "purge_and_extend_with_posterior")],
    "mse": [("multi_dbg.posterior", "min_squared_error_copy_nums_from_freqs")],
}


def module(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


@contextlib.contextmanager
def patched(patches: List[tuple]):
    """Replace ``(module, attribute, function)`` for the duration."""
    saved = []
    try:
        for mod, attr, fn in patches:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def span_patches(span: Callable) -> List[tuple]:
    """Wrappers that run each layer call inside ``span(name)``."""
    out = []
    for name, targets in SPANS.items():
        for modname, attr in targets:
            mod = module(modname)
            orig = getattr(mod, attr)

            def wrapped(*a, __orig=orig, __name=name, **kw):
                with span(__name):
                    return __orig(*a, **kw)

            out.append((mod, attr, functools.wraps(orig)(wrapped)))
    return out


class LaunchRecorder:
    """Records each launch of the kernels named by roofline modules: the
    module's ``HOOK`` (program module, function) is wrapped and
    ``record(*args, **kwargs)`` keeps what its work count needs."""

    def __init__(self, rooflines: Dict[str, object]):
        self.rooflines = rooflines
        self.launches: Dict[str, List[dict]] = {k: [] for k in rooflines}

    def patches(self) -> List[tuple]:
        out = []
        for kid, rl in self.rooflines.items():
            mod = module(rl.HOOK[0])
            orig = getattr(mod, rl.HOOK[1])

            def wrapped(*a, __orig=orig, __kid=kid, __rl=rl, **kw):
                self.launches[__kid].append(__rl.record(*a, **kw))
                return __orig(*a, **kw)

            out.append((mod, rl.HOOK[1], functools.wraps(orig)(wrapped)))
        return out


def graph_of(dbg, compact_copy=None) -> Graph:
    """The plain arrays of a program graph (``MultiDbg``), with its copy
    numbers or the compact ones given."""
    full, comp = dbg.full, dbg.compact
    n_c = comp.n_edges()
    f2c = np.empty(full.n_edges(), dtype=np.int64)
    for ec in range(n_c):
        f2c[np.asarray(dbg.edges_in_full(ec), dtype=np.int64)] = ec
    copy = np.fromiter((w.copy_num for w in full.edge_weights), dtype=np.int64,
                       count=full.n_edges())
    if compact_copy is not None:
        copy = np.asarray(compact_copy, dtype=np.int64)[f2c]
    return Graph(
        k=dbg.k, n_nodes=full.n_nodes(),
        terminal=next((v for v in range(full.n_nodes())
                       if full.node(v).is_terminal), None),
        srcs=np.asarray(full.edge_sources, dtype=np.int64),
        tgts=np.asarray(full.edge_targets, dtype=np.int64),
        bases=np.fromiter((w.base for w in full.edge_weights), dtype=np.int64,
                          count=full.n_edges()),
        copy=copy,
        c_srcs=np.asarray(comp.edge_sources[:n_c], dtype=np.int64),
        c_tgts=np.asarray(comp.edge_targets[:n_c], dtype=np.int64),
        c_nodes=comp.n_nodes(), full_to_compact=f2c)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


HINT_WIDTH = 256  # generate_mappings pads a hint to at most 2 x 128 nodes


def recording(calls: list, fn):
    """``fn`` (generate_mappings) noting each call's graph copy numbers,
    hint and result."""

    def wrapped(dbg, *a, **kw):
        copies = dbg.get_copy_nums()
        out = fn(dbg, *a, **kw)
        calls.append((copies, kw.get("hint"), out))
        return out

    return functools.wraps(fn)(wrapped)


def call_of(calls: list, mappings):
    """(compact copy numbers of the graph, the hint's per-read node sets
    or None) of the call that produced ``mappings``; the hint of a refine
    wins over the decode that called it."""
    found = [(c, h) for c, h, out in calls if out is mappings]
    if not found:
        raise LookupError("no generate_mappings call produced these mappings")
    copies, hint = next(((c, h) for c, h in found if h is not None), found[0])
    return copies, (None if hint is None
                    else [h[:, :HINT_WIDTH] for h in hint.nodes])


class Entry:
    """One unit of a traffic mix on one configuration's inputs.  Every
    ``generate_mappings`` call of a unit is noted (its hint and result, by
    reference) so that a refine can be checked against its own sets."""

    work_unit = ""

    def __init__(self, cfg: dict, traffic: dict, draft_text: str,
                 device: torch.device):
        self.cfg, self.traffic = cfg, traffic
        self.device = device
        self.posterior = module("multi_dbg.posterior")
        self.PHMMParams = module("phmm.params").PHMMParams
        self.draft = module("multi_dbg.output").from_dbg_string(draft_text)
        self.stage_times: Optional[list] = None  # set in a traced run
        self.notes: List[dict] = []  # per-unit readings for the run's log

    def unit(self, reads: List[bytes]) -> dict:
        """Run one unit on ``reads``, wait for the device; returns what it
        produced (program objects), ``work``, the units of work done,
        ``failed``, those that gave no finite answer, and ``reads``."""
        raise NotImplementedError
