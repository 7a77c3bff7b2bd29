"""The comparison that decides ``correct``: what one unit of the measured
window produced, against the float64 reference of ``perfbench/reference``.

Each traffic entry (``perfbench/entries/<entry>.py``) says which numbers
its unit gives (its ``numbers``); this module holds what they share.  A
run is correct when every number that has a limit in
``perfbench/limits/<cell>.json`` is finite and at most that limit; the
other numbers are readings, printed beside them and held by nothing.

Relative gaps are |got - reference| / max(|reference|, 1).  A mapping's
per-base sets are held to the reference's posteriors of the same decode
(:func:`posteriors`, :func:`set_gap`): ``post_gap``, the widest
|S_program - S_reference| (linear, S = F B / P summed over M, I and D)
over the nodes of the program's set and of the reference's, 0 for a node
that a set lacks.

With ``control`` (a dtype), the values the program would give are
computed instead by the reference in that dtype (likelihoods, posteriors
and the sets the mapping rule picks from them) and in float32 (the host
terms, float64 in the program): the benchmark's control.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .reference import graph as G
from .reference import phmm as P

# the program's mapping rule and regimes (``multi_dbg.posterior``): per
# position the top MAPPING_WIDTH nodes by posterior within MAPPING_RATIO
# nats of the best; the decode from scratch by the graph's full edges
MAPPING_WIDTH, MAPPING_RATIO = 128, 30.0
DENSE_MAPPING_MAX_NODES, DENSE_COMPUTE_MAX_NODES = 4000, 32768


def gap(a, b, relative: bool = True) -> float:
    """The widest |a - b|, over max(|b|, 1) when ``relative`` (0 where
    both are -inf)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    both = np.isneginf(a) & np.isneginf(b)
    with np.errstate(invalid="ignore"):
        d = np.abs(np.where(both, 0.0, a - b))
        if relative:
            d = d / np.maximum(np.abs(b), 1.0)
    return float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))


def rows(g, specs, sets_rows, codes, lens, dtype=torch.float64) -> np.ndarray:
    """log P(read) [len(specs), B] over ``specs`` of (compact copy numbers
    or None, Params), each restricted to its entry of ``sets_rows``
    (per-read [L_r, A] node arrays) or, for None, over every node."""
    B, L = codes.shape
    out = np.empty((len(specs), B))
    free = [c for c, sr in enumerate(sets_rows) if sr is None]
    held = [c for c, sr in enumerate(sets_rows) if sr is not None]
    if free:
        m = P.model(g, [specs[c] for c in free], codes.device, dtype)
        out[free] = P.forward(m, codes, lens).double().cpu().numpy()
    if held:
        per = [sets_array(sets_rows[c], L, codes.device) for c in held]
        A = max(x.shape[2] for x in per)
        sets = torch.stack([torch.nn.functional.pad(x, (0, A - x.shape[2]),
                                                    value=-1) for x in per])
        m = P.model(g, [specs[c] for c in held], codes.device, dtype)
        out[held] = P.forward(m, codes, lens, sets).double().cpu().numpy()
    return out


def loss(full, part) -> float:
    """The widest per-read loss of ``part`` against ``full`` (nats)."""
    return float(np.nan_to_num(full - part, nan=np.inf).max(initial=0.0))


def host(gs, cands, mu, sigma, dtype=np.float64) -> np.ndarray:
    """Prior + log Euler count of each candidate, computed in ``dtype``."""
    return np.asarray([
        G.normal_logpdf(G.genome_size(gs, c.copy_nums), mu, sigma, dtype)
        + G.euler_log_count(gs, c.copy_nums, dtype) for c in cands])


def sets_array(sets_list, L: int, device) -> torch.Tensor:
    """Per-read [L_r, A_r] node arrays as one [B, L, A] tensor (-1 pad)."""
    A = max([1] + [int(x.shape[1]) for x in sets_list])
    arr = np.full((len(sets_list), L, A), -1, dtype=np.int64)
    for b, x in enumerate(sets_list):
        arr[b, : x.shape[0], : x.shape[1]] = x
    return torch.as_tensor(arr, device=device)


def decode_keep(g) -> Optional[int]:
    """The cells that a decode from scratch keeps for its backward, by the
    program's regimes (full edges): every node up to 4,000 (the dense
    decode); up to 32,768 the top n_top * (D + 1) by m + i + d at each
    position, n_top = max(40, 256 // (D + 1)) (the dense-compute
    sparse-adaptive decode).  Above, a map seeds and refines, and a decode
    from scratch (the evolving frontier) has no reference here."""
    n = g.n_edges
    if n <= DENSE_MAPPING_MAX_NODES:
        return None
    if n > DENSE_COMPUTE_MAX_NODES:
        raise ValueError(f"no reference for a decode from scratch of {n} "
                         "full edges (the evolving frontier)")
    D = P.degree(g)
    return min(max(40, 256 // (D + 1)) * (D + 1), n)


def posteriors(g, params, codes, lens, sets=None, dtype=torch.float64):
    """(nodes [B, L, W], log S [B, L, W], log P [B]) of a mapping's decode
    on ``g``: restricted to ``sets`` [B, L, A] (a refine over its hint), or
    from scratch over the cells :func:`decode_keep` gives."""
    m = P.model(g, [(None, params)], codes.device, dtype)
    if sets is None:
        tab = P.tables(m, codes, lens, keep=decode_keep(g))
    else:
        tab = P.tables(m, codes, lens, sets=sets[None])
    post = P.posterior(m, codes, lens, tab)
    return tab.nodes[0], post[0], tab.logp[0].double().cpu().numpy()


def select_lists(nodes, logs, lens):
    """The mapping rule (:data:`MAPPING_WIDTH`, :data:`MAPPING_RATIO`) on
    posteriors: per-read ([L_r, k] nodes, logs) arrays."""
    nd, lg = P.select(nodes, logs.double(), MAPPING_WIDTH, MAPPING_RATIO)
    nd, lg = nd.cpu().numpy(), lg.cpu().numpy()
    return ([nd[b, :n] for b, n in enumerate(lens)],
            [lg[b, :n] for b, n in enumerate(lens)])


def set_gap(prog_nodes, prog_logps, ref_nodes, ref_log, chunk: int = 32):
    """A mapping's per-base sets against the reference's posteriors of the
    same reads (``ref_nodes`` / ``ref_log`` [B, L, W]): the widest
    |S_program - S_reference| (linear) over the nodes of the program's set
    and of the set the mapping rule picks from the reference, at every read
    position; a node missing from a set counts 0 there."""
    B, L, W = ref_nodes.shape
    dev = ref_nodes.device
    pn = sets_array(prog_nodes, L, dev)
    pl = torch.full(pn.shape, float("-inf"), dtype=torch.float64, device=dev)
    for b, x in enumerate(prog_logps):
        pl[b, : x.shape[0], : x.shape[1]] = torch.as_tensor(
            np.asarray(x, dtype=np.float64), device=dev)
    worst = 0.0
    for j0 in range(0, L, chunk):
        sl = slice(j0, min(L, j0 + chunk))
        rn, rl = ref_nodes[:, sl], ref_log[:, sl].double()
        a, al = pn[:, sl], pl[:, sl]
        live = a >= 0
        # the program's nodes: its S against the reference's there
        eq = (a[..., :, None] == rn[..., None, :]) & live[..., None]
        at = torch.where(eq, rl.exp()[..., None, :], 0.0).sum(-1)
        d = torch.where(live, (al.exp() - at).abs(), 0.0)
        # the reference's picks that the program's set lacks
        sn, sv = P.select(rn, rl, MAPPING_WIDTH, MAPPING_RATIO)
        lacks = (sn >= 0) & ~((sn[..., :, None] == a[..., None, :])
                              & live[..., None, :]).any(-1)
        d2 = torch.where(lacks, sv.exp(), 0.0)
        for x in (d, d2):
            worst = max(worst, float(torch.nan_to_num(
                x, nan=float("inf")).max()))
    return worst


def numbers(entry_mod, entry, captured: dict, cfg: dict, traffic: dict,
            seed: int, device, control: Optional[torch.dtype] = None) -> dict:
    """The numbers of one captured unit, by the entry's own comparison
    (``entry_mod.numbers``): {"program": {name: value}} and, given a
    ``control`` dtype, {"control": ...} too."""
    rng = np.random.default_rng([int(seed), 1])
    return entry_mod.numbers(entry, captured, cfg, traffic, rng, device,
                             control)


def judge(values: dict, limits: dict) -> bool:
    """Every number that has a limit finite and within it; the others are
    readings that nothing holds."""
    ok = True
    for name, lim in limits.items():
        v = values.get(name)
        if v is None or lim is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok
