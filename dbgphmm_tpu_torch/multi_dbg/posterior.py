"""Bayesian posterior sampling over copy-number assignments, seeded regime
(ref: src/multi_dbg/posterior.rs).

PyTorch counterpart of ``dbgphmm_tpu/multi_dbg/posterior.py``.  The score
of an assignment X is ``P(X|R) ∝ P(R|X) · P(G) · #EulerCircuits(X)``: the
read likelihoods come from :class:`~dbgphmm_tpu_torch.ops.mapped_scorer.
MappedScorer` (a CUDA kernel on a GPU, its float64 twin on the CPU), the
prior and the Euler count from the port's copies of the host layers.

What is ported: mapping generation by exact-match seeding plus the
hint-constrained refine (graphs of more than ``DENSE_COMPUTE_MAX_NODES``
full edges, or any graph given a ``hint``), candidate scoring in the
scorer's three spaces with the linear-to-log rescue, the greedy hill
climb, purge + extension, and the k-extension loop.  What is not: the
dense and sparse-adaptive from-scratch decodes that serve smaller graphs
(ROADMAP 'Modules to port', items 7 and 8) — such a call raises
``NotImplementedError`` instead of taking another route — and the
TPU-specific crash/revival machinery and the XLA fallback scorer of the
JAX module.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..graph.euler import EulerCache
from ..hist import DiscreteDistribution
from ..ops.adaptive import mappings_refine
from ..ops.forward import default_dtype, pad_reads, to_device
from ..ops.mapped_scorer import MappedScorer
from ..ops.sparse import pad_mappings, precompute_positions
from ..phmm.params import PHMMParams
from ..phmm.template import make_template
from ..prob import NEG_INF, ladd, normal_bin_logp
from . import MultiDbg
from .draft import min_squared_error_copy_nums_from_freqs
from .neighbors import (
    NeighborConfig,
    UpdateInfo,
    apply_update_cycle,
    is_independent_update,
    to_neighbor_copy_nums_and_infos,
    to_rescue_neighbors,
)
from .seed import seed_mappings_arrays

DENSE_MAPPING_MAX_NODES = 4000  # dense decode up to here (not ported yet)
DENSE_COMPUTE_MAX_NODES = 32768  # beyond this, mappings come from seeding
MAPPING_WIDTH_CAP = 128  # fixed-shape cap on mapping slots (score-ratio
# selected below it; ref table.rs:22 MAX_ACTIVE_NODES)
MAPPING_READ_CHUNK = 160  # the refine stores [L, B, A] tables; chunk reads

NOT_PORTED_DECODE = (
    "from-scratch mapping decode of a graph with at most "
    "DENSE_COMPUTE_MAX_NODES full edges: the dense and sparse-adaptive "
    "decodes are not ported yet (ROADMAP 'Modules to port', items 7 and 8); "
    "pass a hint (e.g. seeded mappings) instead"
)


# -- per-stage timing ---------------------------------------------------------


@dataclass
class StageTimes:
    """Wall-clock split of one k-stage (host clock; device work is
    synchronised where it is timed)."""

    k: int
    seed_s: float = 0.0  # seed_mappings_arrays (host)
    refine_s: float = 0.0  # mappings_refine (device) incl. transfers
    setup_s: float = 0.0  # template, positions, scorer streams
    score_s: float = 0.0  # read likelihoods of candidates (device)
    n_scorings: int = 0  # candidates x reads scored
    n_rescued: int = 0  # linear-space candidates rescored in log space
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["host_s"] = self.wall_s - (self.seed_s + self.refine_s + self.setup_s
                                     + self.score_s)
        d["scorings_per_s"] = (self.n_scorings / self.score_s
                               if self.score_s > 0 else 0.0)
        return d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- mappings -----------------------------------------------------------------


@dataclass
class Mappings:
    """Per-read, per-base candidate PHMM nodes (= full-DBG edges) with log
    probs (ref: src/hmmv2/hint.rs Mapping/Mappings).

    ``nodes[r]`` is int32 [L_r, A] (-1 padding); ``logps[r]`` matches.
    ``read_logps`` holds each read's log-likelihood from the decode that
    produced the mapping; ``anchor_logps`` that of its last from-scratch
    decode (both gate hint-seeded regeneration across k)."""

    nodes: List[np.ndarray]
    logps: List[np.ndarray]
    read_logps: Optional[np.ndarray] = None
    anchor_logps: Optional[np.ndarray] = None
    stages_since_anchor: int = 0
    gate_rate: float = 0.0
    # per-(read, node) mass cap against posterior absorption into
    # low-complexity self-loop regions (see the JAX module)
    MAX_NODE_MASS_PER_READ = 50.0

    def n_reads(self) -> int:
        return len(self.nodes)

    @classmethod
    def _mass_cap(cls, read_len: int) -> float:
        return max(cls.MAX_NODE_MASS_PER_READ, 0.02 * read_len)

    def mass_cap_total(self) -> float:
        return sum(self._mass_cap(n.shape[0]) for n in self.nodes)

    def to_node_freqs(self, n_nodes: int) -> np.ndarray:
        """Expected usage per node, linear space (ref: hint.rs:161-171),
        each read's per-node contribution capped."""
        freqs = np.zeros(n_nodes)
        for nodes, logps in zip(self.nodes, self.logps):
            valid = nodes >= 0
            mass = np.bincount(
                nodes[valid], weights=np.exp(logps[valid]), minlength=n_nodes
            )[:n_nodes]
            freqs += np.minimum(mass, self._mass_cap(nodes.shape[0]))
        return freqs


def _trim_mapping_width(mn: np.ndarray, ml: np.ndarray, align: int = 16):
    """Slice [B, L, CAP] mapping arrays to the observed width (max valid
    slots per position), aligned up; valid slots are a prefix of each row."""
    valid = mn >= 0
    width = max(int(valid.sum(axis=2).max(initial=1)), 1)
    width = min(-(-width // align) * align, mn.shape[2])
    return mn[:, :, :width], ml[:, :, :width]


def _pad_hint_nodes(hint: Mappings, L: int, cap: int) -> np.ndarray:
    """Stack per-read hint node lists into one [B, L, A] int32 array."""
    B = hint.n_reads()
    A = max(1, min(cap, max((m.shape[1] for m in hint.nodes), default=1)))
    out = np.full((B, L, A), -1, dtype=np.int32)
    for r, m in enumerate(hint.nodes):
        w = min(A, m.shape[1])
        out[r, : m.shape[0], :w] = m[:, :w]
    return out


def generate_mappings(
    dbg: MultiDbg,
    params: PHMMParams,
    reads,
    device,
    n_active: int = MAPPING_WIDTH_CAP,
    dtype: Optional[torch.dtype] = None,
    max_ratio: Optional[float] = "default",
    hint: Optional[Mappings] = None,
    hint_gate: float = 100.0,
    verbose: bool = False,
    read_chunk: int = MAPPING_READ_CHUNK,
    pad_to: Optional[int] = None,
    hint_regen: bool = True,
    times: Optional[StageTimes] = None,
) -> Mappings:
    """Per-base active nodes by score ratio under a top-k cap
    (ref: posterior.rs:609-637 generate_mappings; hint.rs:193-220).

    Without ``hint``, a graph of more than DENSE_COMPUTE_MAX_NODES full
    edges is seeded by exact k-mer suffix matching (multi_dbg.seed) and the
    seeds are refined; smaller graphs raise ``NotImplementedError``.  With
    ``hint``, the decode is restricted to the hint's per-base sets
    (``mappings_refine``) and gated: a read whose constrained likelihood is
    non-finite, below ~-5 nats/base, or more than ``hint_gate`` nats below
    its previous / anchor likelihood is regenerated from scratch (or, with
    ``hint_regen=False``, kept and reported)."""
    device = torch.device(device)
    if dtype is None:
        dtype = default_dtype(device)
    if max_ratio == "default":
        max_ratio = params.active_node_max_ratio

    if hint is None:
        if dbg.n_edges_full() <= DENSE_COMPUTE_MAX_NODES:
            raise NotImplementedError(NOT_PORTED_DECODE)
        t0 = time.perf_counter()
        arrs = seed_mappings_arrays(dbg, reads, verbose=True)
        if times is not None:
            times.seed_s += time.perf_counter() - t0
        seeds = Mappings(arrs, [np.zeros(a.shape) for a in arrs], None, None, -1)
        return generate_mappings(
            dbg, params, reads, device, n_active=n_active, dtype=dtype,
            max_ratio=max_ratio, hint=seeds, hint_gate=hint_gate,
            verbose=verbose, read_chunk=read_chunk, pad_to=pad_to,
            hint_regen=False, times=times,
        )

    if read_chunk and len(reads) > read_chunk:
        reads_l = list(reads)
        L_max = max(len(r) for r in reads_l)
        parts = []
        for c0 in range(0, len(reads_l), read_chunk):
            sl = slice(c0, c0 + read_chunk)
            sub_hint = Mappings(
                hint.nodes[sl], hint.logps[sl],
                None if hint.read_logps is None else hint.read_logps[sl],
                None if hint.anchor_logps is None else hint.anchor_logps[sl],
                hint.stages_since_anchor,
            )
            parts.append(generate_mappings(
                dbg, params, reads_l[sl], device, n_active=n_active,
                dtype=dtype, max_ratio=max_ratio, hint=sub_hint,
                hint_gate=hint_gate, verbose=verbose, read_chunk=0,
                pad_to=L_max, hint_regen=hint_regen, times=times,
            ))
        return Mappings(
            [a for p in parts for a in p.nodes],
            [a for p in parts for a in p.logps],
            np.concatenate([p.read_logps for p in parts]),
            np.concatenate([p.anchor_logps for p in parts]),
            max(p.stages_since_anchor for p in parts),
        )

    t0 = time.perf_counter()
    model = dbg.to_phmm(params, mode="non_zero")
    dm = to_device(model, device, dtype)
    codes, lens = pad_reads(list(reads), pad_to=pad_to)
    n_reads = codes.shape[0]
    hint_arr = _pad_hint_nodes(hint, codes.shape[1], 2 * n_active)
    on_dev = lambda a: torch.as_tensor(a, device=device)
    logp, map_nodes, map_logp = mappings_refine(
        dm, on_dev(codes), on_dev(lens), on_dev(hint_arr),
        n_active=n_active, max_ratio=max_ratio,
    )
    read_logps = logp.to("cpu", torch.float64).numpy()[:n_reads]
    mn = map_nodes.cpu().numpy()[:n_reads]
    ml = map_logp.cpu().numpy()[:n_reads]
    if times is not None:
        times.refine_s += time.perf_counter() - t0
    mn, ml = _trim_mapping_width(mn, ml)
    nodes, logps = [], []
    for i, L in enumerate(lens):
        nodes.append(mn[i, :L].copy())
        logps.append(ml[i, :L].copy())

    # acceptance gate: per-stage drop vs the previous constrained value and
    # total drop vs the last from-scratch decode (anchor), plus an absolute
    # floor of -5 nats/base
    anchor = hint.anchor_logps
    if anchor is None:
        anchor = hint.read_logps
    bad = ~np.isfinite(read_logps)
    lens_np = np.asarray([n.shape[0] for n in nodes], dtype=np.float64)
    with np.errstate(invalid="ignore"):
        bad |= read_logps < -5.0 * np.maximum(lens_np, 1.0)
    for ref_lp in (hint.read_logps, anchor):
        if ref_lp is not None:
            ref_lp = np.asarray(ref_lp, dtype=np.float64)
            if ref_lp.shape == read_logps.shape:
                with np.errstate(invalid="ignore"):
                    bad |= read_logps < (ref_lp - hint_gate)
    anchor_out = (np.asarray(anchor, dtype=np.float64).copy()
                  if anchor is not None and np.shape(anchor) == read_logps.shape
                  else read_logps.copy())
    gate_rate = float(bad.mean())
    if bad.any() and not hint_regen:
        # seeded mappings: re-decoding from scratch would re-enter seeding;
        # keep the constrained result and let the score carry the penalty
        print(f"[mappings] {int(bad.sum())}/{n_reads} reads below the "
              "likelihood floor under seeded sets (kept)")
    if bad.any() and hint_regen:
        idx = np.flatnonzero(bad)
        print(f"[mappings] hint gate: regenerating {len(idx)}/"
              f"{n_reads} reads from scratch")
        fresh = generate_mappings(
            dbg, params, [reads[int(i)] for i in idx], device,
            n_active=n_active, dtype=dtype, max_ratio=max_ratio,
            pad_to=codes.shape[1], times=times,
        )
        for j, i in enumerate(idx):
            nodes[int(i)] = fresh.nodes[j]
            logps[int(i)] = fresh.logps[j]
            read_logps[int(i)] = fresh.read_logps[j]
            anchor_out[int(i)] = fresh.read_logps[j]

    return Mappings(nodes, logps, read_logps, anchor_out,
                    hint.stages_since_anchor + 1, gate_rate)


# -- score --------------------------------------------------------------------


@dataclass
class Score:
    """(ref: posterior.rs:170-206). All probabilities in log space."""

    likelihood: float
    prior: float
    genome_size: int
    n_euler_circuits: float
    time_likelihood: float = 0.0
    time_euler: float = 0.0

    def p(self) -> float:
        return self.likelihood + self.prior + self.n_euler_circuits

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "Score":
        return Score(**json.loads(s))


@dataclass
class PosteriorSample:
    copy_nums: List[int]
    score: Score
    infos: List[UpdateInfo] = field(default_factory=list)

    def to_infos_string(self) -> str:
        return "[" + ",".join(str(i) for i in self.infos) + "]"


class Posterior:
    """(ref: posterior.rs:31-161)"""

    def __init__(self):
        self.samples: List[PosteriorSample] = []
        self.p: float = NEG_INF
        self._seen = {}

    def add(self, sample: PosteriorSample) -> None:
        key = tuple(sample.copy_nums)
        if key not in self._seen:
            self._seen[key] = sample
            self.p = ladd(self.p, sample.score.p())
            self.samples.append(sample)

    def contains(self, copy_nums: Sequence[int]) -> bool:
        return tuple(copy_nums) in self._seen

    def find(self, copy_nums: Sequence[int]) -> Optional[PosteriorSample]:
        return self._seen.get(tuple(copy_nums))

    def max_sample(self) -> PosteriorSample:
        return max(self.samples, key=lambda s: s.score.p())

    def max_copy_nums(self) -> List[int]:
        return self.max_sample().copy_nums

    def p_edge(self, edge: int) -> DiscreteDistribution:
        """Posterior distribution of one compact edge's copy number."""
        return DiscreteDistribution.from_occurs(
            (s.copy_nums[edge], s.score.p() - self.p) for s in self.samples
        )

    def p_edge_x(self, edge: int, x: int) -> float:
        """Log P(X(e)=x | R)."""
        return self.p_edge(edge).logp.get(x, NEG_INF)


def to_prior(dbg: MultiDbg, genome_size_expected: int,
             genome_size_sigma: int) -> float:
    """(ref: posterior.rs:230-241)"""
    return normal_bin_logp(
        dbg.genome_size(), float(genome_size_expected), float(genome_size_sigma)
    )


class _CompactFlow:
    """Copy-number arithmetic on the compact graph, vectorised: the genome
    size of an assignment is a dot product with the per-edge count of
    non-null k-mers, and flow conservation at compact nodes is flow
    conservation of the full graph (inner nodes of a compact edge conserve
    trivially).  Same values as ``MultiDbg.set_copy_nums`` +
    ``genome_size()``, without their O(full edges) Python loops per
    candidate."""

    def __init__(self, dbg: MultiDbg):
        n = dbg.n_edges_compact()
        self.n_nodes = dbg.n_nodes_compact()
        self.src = np.asarray(dbg.compact.edge_sources[:n], dtype=np.int64)
        self.dst = np.asarray(dbg.compact.edge_targets[:n], dtype=np.int64)
        self.size = np.asarray([
            sum(1 for ef in dbg.edges_in_full(e)
                if not dbg.full.edge(ef).is_null_base())
            for e in range(n)
        ], dtype=np.int64)

    def genome_size(self, copy_nums) -> int:
        cn = np.asarray(copy_nums, dtype=np.int64)
        bal = np.bincount(self.src, cn, self.n_nodes) - np.bincount(
            self.dst, cn, self.n_nodes)
        if len(cn) != len(self.size) or np.any(bal != 0):
            raise ValueError("invalid copy numbers: not a flow on the graph")
        return int(cn @ self.size)


def make_scorer(template, positions, codes, lens, params, device,
                 space: str = "packed") -> MappedScorer:
    """The candidate scorer of one k-stage (ref: ``make_pallas_scorer``):
    K1 ("packed", the default), K2 ("log") or K3 ("linear")."""
    return MappedScorer(template, positions, codes, lens, params, device,
                        space=space)


def score_candidates(
    dbg: MultiDbg,
    candidates: List[List[int]],
    genome_size_expected: int,
    genome_size_sigma: int,
    scorer: MappedScorer,
    times: Optional[StageTimes] = None,
) -> List[Score]:
    """Score a batch of copy-number candidates: read likelihoods from the
    scorer (one call for the whole batch), prior and incremental Euler
    counts on the host.

    A linear-space scorer underflows to -inf on reads forced across copy-0
    edges; every candidate it flags is rescored by its log-space sibling,
    whose very low but finite sums steer the early climb.  A log-space
    -inf is exact, so "log" and "packed" results are never rescored."""
    t0 = time.perf_counter()
    lls, ok = scorer.scores_detailed(candidates)
    bad = (np.flatnonzero(~ok) if scorer.space == "linear"
           else np.empty(0, dtype=np.int64))
    if bad.size:
        exact, _ = scorer.log_sibling().scores_detailed(
            [candidates[i] for i in bad])
        lls[bad] = exact
    t_like = time.perf_counter() - t0
    if times is not None:
        times.score_s += t_like
        times.n_scorings += (len(candidates) + bad.size) * scorer.n_reads
        times.n_rescued += int(bad.size)

    scores = []
    flow = _CompactFlow(dbg)
    # candidates are +-1-cycle neighbours of the base assignment: the
    # log-det factors once and each candidate is a rank-r update
    ecache = EulerCache(dbg.compact, dbg.get_copy_nums())
    for cn, ll in zip(candidates, lls):
        t1 = time.perf_counter()
        size = flow.genome_size(cn)
        n_ec = ecache.count(cn)
        scores.append(Score(
            likelihood=float(ll),
            prior=normal_bin_logp(size, float(genome_size_expected),
                                  float(genome_size_sigma)),
            genome_size=size,
            n_euler_circuits=n_ec,
            time_likelihood=t_like / len(candidates),
            time_euler=time.perf_counter() - t1,
        ))
    return scores


# -- greedy posterior sampling (ref: posterior.rs:314-600) --------------------


def sample_posterior(
    dbg: MultiDbg,
    params: PHMMParams,
    reads,
    mappings: Mappings,
    genome_size_expected: int,
    genome_size_sigma: int,
    device,
    neighbor_config: Optional[NeighborConfig] = None,
    max_iter: int = 100,
    rescue_only: bool = True,
    verbose: bool = False,
    times: Optional[StageTimes] = None,
    scorer_space: str = "packed",
) -> Posterior:
    """Greedy hill climb from the DBG's copy numbers: score rescue (and,
    with ``rescue_only=False``, short/long/reducer) neighbours, move to the
    best, repeat up to ``max_iter`` moves.  ``scorer_space`` picks the
    scorer's kernel (:func:`make_scorer`)."""
    if mappings is None:
        raise NotImplementedError(
            "scoring without mappings (batch scoring, ROADMAP 'Modules to "
            "port' item 9) is not ported yet")
    device = torch.device(device)
    if neighbor_config is None:
        neighbor_config = NeighborConfig()
    log = (lambda *a: print("[posterior]", *a)) if verbose else (lambda *a: None)

    post = Posterior()
    copy_nums = dbg.get_copy_nums()
    infos: List[UpdateInfo] = []
    work = dbg.copy()
    t0 = time.perf_counter()
    codes, lens = pad_reads(list(reads))
    template = make_template(dbg, params)
    freqs = mappings.to_node_freqs(dbg.n_edges_full())
    width = max((n.shape[1] for n in mappings.nodes if n.size), default=8)
    map_nodes = pad_mappings(mappings, codes.shape[1], width)
    # a read with an entirely empty mapping scores -inf under every
    # candidate and carries no signal: drop it from scoring
    alive = (map_nodes >= 0).any(axis=(1, 2))
    if not alive.all():
        dead = np.flatnonzero(~alive)
        print(f"[posterior] excluding {len(dead)} read(s) with empty "
              f"mappings from scoring: {dead.tolist()}")
        keep = np.flatnonzero(alive)
        codes, lens = codes[keep], lens[keep]
        map_nodes = map_nodes[keep]
        reads = [reads[int(i)] for i in keep]
    positions = precompute_positions(
        map_nodes, template.parent_idx, parent_exists=template.parent_exists
    )
    scorer = make_scorer(template, positions, codes, lens, template.params,
                         device, space=scorer_space)
    _sync(device)
    t_setup = time.perf_counter() - t0
    if times is not None:
        times.setup_s += t_setup
    log(f"setup: template, positions and scorer streams {t_setup:.1f}s "
        f"(width={width}, {len(scorer.chunks)} read chunk(s))")
    coverage = sum(len(r) for r in reads) / genome_size_expected

    def score(cands):
        return score_candidates(work, cands, genome_size_expected,
                                genome_size_sigma, scorer, times)

    def evaluate_batch(cands_infos, infos_init):
        seen = set()
        uniq = []
        for cn, info in cands_infos:
            key = tuple(cn)
            if not post.contains(cn) and key not in seen:
                seen.add(key)
                uniq.append((cn, info))
        if not uniq:
            return
        t1 = time.perf_counter()
        scores = score([cn for cn, _i in uniq])
        log(f"  scored {len(uniq)} candidates in {time.perf_counter()-t1:.1f}s")
        for (cn, info), sc in zip(uniq, scores):
            post.add(PosteriorSample(cn, sc, infos_init + [info]))

    post.add(PosteriorSample(copy_nums, score([copy_nums])[0], []))

    n_iter = 0
    while n_iter < max_iter:
        work.set_copy_nums(copy_nums)
        t1 = time.perf_counter()
        nc = neighbor_config
        rescue = to_rescue_neighbors(
            work, freqs, coverage,
            nc.rescue_k_non_zero, nc.rescue_k_zero,
            nc.rescue_weighted_by_copy_num, nc.rescue_k_total,
            nc.rescue_sort_by_freq,
        )
        log(f"iter {n_iter}: {len(rescue)} rescue neighbors "
            f"({time.perf_counter()-t1:.1f}s)")
        if rescue_only:
            sets = [rescue]
        else:
            partial = to_neighbor_copy_nums_and_infos(
                work,
                NeighborConfig(
                    max_cycle_size=5, max_flip=2, use_long_cycles=True,
                    ignore_cycles_passing_terminal=True, use_reducers=False,
                ),
            )
            full = to_neighbor_copy_nums_and_infos(work, neighbor_config)
            sets = [rescue, partial, full]

        moved = False
        for cands in sets:
            if not cands:
                continue
            evaluate_batch(cands, infos)
            # multi-move in rescue_only mode (ref: posterior.rs:532-590)
            if rescue_only:
                current_score = post.find(copy_nums).score
                ranked = sorted(
                    (c for c in cands if post.contains(c[0])),
                    key=lambda c: post.find(c[0]).score.p(),
                    reverse=True,
                )
                cur = list(copy_nums)
                accepted = []
                for cn, info in ranked:
                    if post.find(cn).score.p() <= current_score.p():
                        break
                    cyc = info.cycle()
                    if is_independent_update(accepted, cyc):
                        apply_update_cycle(cur, cyc)
                        accepted.append(cyc)
                if accepted and not post.contains(cur):
                    mm_info = UpdateInfo(accepted, "multi_move")
                    post.add(PosteriorSample(cur, score([cur])[0],
                                             infos + [mm_info]))

            best = post.max_sample()
            if best.copy_nums != copy_nums:
                copy_nums = best.copy_nums
                infos = best.infos
                n_iter += 1
                moved = True
                log(f"moved to p={best.score.p():.3f} via {best.to_infos_string()}")
                break
        if not moved:
            log(f"iter {n_iter}: local optimum")
            break
    return post


def purge_and_extend_with_posterior(
    dbg: MultiDbg,
    posterior: Posterior,
    k_max: int,
    p0: float,
    paths=None,
    mappings: Optional[Mappings] = None,
):
    """(ref: posterior.rs:644-695). ``p0`` is a linear probability."""
    work = dbg.copy()
    work.set_copy_nums(posterior.max_copy_nums())
    edges_purge = []
    lp0 = np.log(p0) if p0 > 0 else NEG_INF
    for e in range(work.n_edges_compact()):
        if (work.copy_num_of_edge_in_compact(e) == 0
                and posterior.p_edge_x(e, 0) > lp0):
            edges_purge.append(e)
    if paths is not None and edges_purge:
        # per-edge forensics before the purge maps are gone
        true_full = set()
        for p in paths:
            if p is not None:
                true_full.update(int(x) for x in p)
        for e in edges_purge:
            full = [int(x) for x in work.edges_in_full(e)]
            n_true = sum(1 for x in full if x in true_full)
            if n_true:
                print(f"[infer] TRUTH-PURGE k={work.k}: compact e{e} "
                      f"({len(full)} full edges, {n_true} on a true path) "
                      f"p(0)={np.exp(posterior.p_edge_x(e, 0)):.4f} "
                      f"copy_max={work.copy_num_of_edge_in_compact(e)}")
    return work.purge_and_extend(
        edges_purge, k_max, True, paths,
        list(mappings.nodes) if mappings is not None else None,
    )


# -- top-level loop (ref: posterior.rs:698-826) --------------------------------


def infer_posterior_by_extension(
    k_max: int,
    dbg_init: MultiDbg,
    param_infer: PHMMParams,
    param_error: PHMMParams,
    reads,
    genome_size_expected: int,
    genome_size_sigma: int,
    device,
    neighbor_config: Optional[NeighborConfig] = None,
    max_iter: int = 100,
    p0: float = 0.8,
    on_iter: Optional[Callable] = None,
    paths=None,
    mappings: Optional[Mappings] = None,
    n_haplotypes: Optional[int] = None,
    verbose: bool = False,
    use_hint_mappings: bool = True,
    stage_times: Optional[List[StageTimes]] = None,
    scorer_space: str = "packed",
):
    """Per k: hill-climb the copy numbers, purge likely-zero edges, extend
    to k+1, regenerate mappings, re-initialise copy numbers from mapping
    frequencies; at k_max a final full-neighbourhood pass with the error
    parameters.  Returns (dbg, posterior, paths, mappings).

    ``stage_times`` (a list) receives one :class:`StageTimes` per k-stage
    and one for the final pass (``k`` = -1).  ``scorer_space`` is passed to
    every :func:`sample_posterior`."""
    log = (lambda *a: print("[infer]", *a)) if verbose else (lambda *a: None)
    device = torch.device(device)
    dbg = dbg_init.copy()
    t_stage = time.perf_counter()
    times = StageTimes(k=dbg.k)
    if mappings is None:
        mappings = generate_mappings(dbg, param_error, reads, device,
                                     times=times)
    coverage = sum(len(r) for r in reads) / genome_size_expected

    def close_stage(next_k: int) -> StageTimes:
        nonlocal t_stage
        now = time.perf_counter()
        times.wall_s = now - t_stage
        t_stage = now
        if stage_times is not None:
            stage_times.append(times)
        return StageTimes(k=next_k)

    while True:
        t0 = time.perf_counter()
        posterior = sample_posterior(
            dbg, param_infer, reads, mappings, genome_size_expected,
            genome_size_sigma, device, neighbor_config, max_iter,
            rescue_only=True, verbose=verbose, times=times,
            scorer_space=scorer_space,
        )
        dbg.set_copy_nums(posterior.max_copy_nums())
        log(f"k={dbg.k} posterior sampled in {time.perf_counter()-t0:.1f}s "
            f"({len(posterior.samples)} samples)")

        if on_iter is not None:
            on_iter(dbg, posterior, paths, mappings)

        if dbg.k >= k_max:
            break

        t0 = time.perf_counter()
        n_true_before = (
            sum(1 for p in paths if p is not None) if paths is not None else 0
        )
        dbg, paths, maps2 = purge_and_extend_with_posterior(
            dbg, posterior, k_max, p0, paths,
            mappings if use_hint_mappings else None,
        )
        if paths is not None:
            n_true_after = sum(1 for p in paths if p is not None)
            if n_true_after < n_true_before:
                print(f"[infer] TRUTH LOST: purge at k={dbg.k} removed "
                      f"edges of {n_true_before - n_true_after} true "
                      f"haplotype path(s) ({n_true_after} still tracked)")
        log(f"extended to k={dbg.k} in {time.perf_counter()-t0:.1f}s")
        times = close_stage(dbg.k)
        t0 = time.perf_counter()
        hint_m = None
        if dbg.n_edges_full() > DENSE_COMPUTE_MAX_NODES:
            # seeded regime: seeding each stage beats upconverting the
            # previous stage's sets, so the hint is not carried
            maps2 = None
        elif getattr(mappings, "gate_rate", 0.0) >= 0.99:
            maps2 = None  # the previous hint decode was junk for every read
        if use_hint_mappings and maps2 is not None:
            hint_m = Mappings(
                maps2, [np.zeros(a.shape) for a in maps2],
                mappings.read_logps, mappings.anchor_logps,
                mappings.stages_since_anchor,
            )
        mappings = generate_mappings(
            dbg, param_error, reads, device, hint=hint_m, verbose=verbose,
            times=times,
        )
        log(f"mappings {'refined' if hint_m is not None else 'regenerated'} "
            f"in {time.perf_counter()-t0:.1f}s")
        t0 = time.perf_counter()
        freqs = mappings.to_node_freqs(dbg.n_edges_full())
        # guard: capped node freqs are bounded by the per-read caps; a
        # blown-up value means a junk mapping, so decode from scratch
        limit = max(mappings.mass_cap_total(), 1.0)
        if freqs.max(initial=0.0) > limit:
            print(f"[infer] mapping freqs blown up (max {freqs.max():.0f} "
                  f"> {limit:.0f}); regenerating mappings from scratch")
            mappings = generate_mappings(dbg, param_error, reads, device,
                                         verbose=verbose, times=times)
            freqs = mappings.to_node_freqs(dbg.n_edges_full())
        # the reference hardcodes 2 haplotypes here (posterior.rs:798); the
        # count is fixed only when a terminal node exists
        nh = n_haplotypes if n_haplotypes is not None else 2
        if dbg.terminal_node_compact() is None:
            nh = None
        cn = min_squared_error_copy_nums_from_freqs(
            dbg, freqs, coverage, nh, fallback_copy_nums=dbg.get_copy_nums()
        )
        dbg.set_copy_nums(cn)
        log(f"copy nums re-initialized from freqs in {time.perf_counter()-t0:.1f}s")

    # final full-neighbourhood sampling with the error params
    times = close_stage(-1)
    mappings = generate_mappings(dbg, param_error, reads, device, times=times)
    posterior = sample_posterior(
        dbg, param_error, reads, mappings, genome_size_expected,
        genome_size_sigma, device, neighbor_config, max_iter,
        rescue_only=False, verbose=verbose, times=times,
        scorer_space=scorer_space,
    )
    dbg.set_copy_nums(posterior.max_copy_nums())
    close_stage(-1)
    return dbg, posterior, paths, mappings
