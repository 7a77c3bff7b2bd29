"""Generative read sampling from the PHMM error model
(ref: src/hmmv2/sample.rs, src/graph/genome_graph.rs:328-424).

Reads are emitted by walking the profile HMM along a genome haplotype
(optionally its reverse complement): Match emits the genome base (or a
mismatch), Ins emits a random base, Del skips a genome base.  Every emitted
base records its ground-truth origin, which is the e2e harness's truth label
(ref: PositionedSequence, collection.rs:508-726).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..seq.collection import (
    BASES,
    GenomeGraphPos,
    PositionedSequence,
    revcomp,
)
from .params import PHMMParams


@dataclass
class SampleProfile:
    """(ref: sample.rs:92-156 SampleProfile)"""

    total_bases: Optional[int] = None  # ReadAmount::TotalBases
    n_reads: Optional[int] = None  # ReadAmount::Count
    length: int = 1000  # state count limit per read
    start_points_all: bool = False  # StartPoints::AllStartPoints (full length)
    seed: int = 0
    # ReadLength::Endable vs StateCount (sample.rs:117-133): only Endable
    # lets p_end terminate reads early; the reference's e2e profiles all use
    # StateCount/EmitCount (endable=False), otherwise ~1-exp(-L*p_end) of
    # long reads end early and skew the length distribution (ADVICE r2)
    endable: bool = False


def _sample_read_from_hap(
    seq: bytes,
    hap_id: int,
    start: int,
    max_states: int,
    params: PHMMParams,
    rng: np.random.Generator,
    is_revcomp: bool,
) -> PositionedSequence:
    """Walk M/I/D states from `start` along `seq`, emitting bases with the
    PHMM error model (ref: sample.rs:160-280)."""
    L = len(seq)
    out = bytearray()
    origins: List[GenomeGraphPos] = []
    pos = start
    state = "M"
    # normalized per-state transition distributions (excluding p_end which is
    # applied first at each step)
    p_end = params.p_end
    trans = {
        "M": [("M", params.p_MM), ("I", params.p_MI), ("D", params.p_MD)],
        "I": [("M", params.p_IM), ("I", params.p_II), ("D", params.p_ID)],
        "D": [("M", params.p_DM), ("I", params.p_DI), ("D", params.p_DD)],
    }
    bases = np.frombuffer(BASES, dtype=np.uint8)

    for _step in range(max_states):
        if pos >= L:
            break
        if rng.random() < p_end:
            break
        if state == "M":
            b = seq[pos]
            if rng.random() < params.p_mismatch:
                others = [c for c in BASES if c != b]
                b = others[rng.integers(0, 3)]
            out.append(b)
            if is_revcomp:
                origins.append(GenomeGraphPos(hap_id, L - 1 - pos))
            else:
                origins.append(GenomeGraphPos(hap_id, pos))
            pos += 1
        elif state == "I":
            out.append(int(bases[rng.integers(0, 4)]))
            origins.append(GenomeGraphPos())
        else:  # D
            pos += 1
        # next state
        names, probs = zip(*trans[state])
        probs = np.asarray(probs)
        probs = probs / probs.sum()
        state = names[rng.choice(len(names), p=probs)]

    return PositionedSequence(bytes(out), origins, is_revcomp=is_revcomp)


def sample_positioned_reads(
    genome_seqs: List[bytes],
    params: PHMMParams,
    profile: SampleProfile,
    has_revcomp: bool = False,
) -> List[PositionedSequence]:
    """Sample reads from a genome with the PHMM error model
    (ref: genome_graph.rs:399-424 sample_positioned_reads)."""
    rng = np.random.Generator(np.random.PCG64(profile.seed))
    lengths = np.array([len(s) for s in genome_seqs], dtype=np.float64)
    p_hap = lengths / lengths.sum()

    reads: List[PositionedSequence] = []
    total = 0

    def one_read() -> PositionedSequence:
        hap = int(rng.choice(len(genome_seqs), p=p_hap))
        seq = genome_seqs[hap]
        rc = bool(has_revcomp and rng.random() < 0.5)
        walk_seq = revcomp(seq) if rc else seq
        if profile.start_points_all:
            start = 0
        else:
            start = int(rng.integers(0, len(seq)))
        return _sample_read_from_hap(
            walk_seq, hap, start, profile.length, params, rng, rc
        )

    if profile.n_reads is not None:
        for _ in range(profile.n_reads):
            reads.append(one_read())
    else:
        assert profile.total_bases is not None
        while total < profile.total_bases:
            r = one_read()
            if len(r) == 0:
                continue
            reads.append(r)
            total += len(r)
    return reads


# -- graph-PHMM generative sampling (ref: src/hmmv2/sample.rs:160-446,
#    src/hmmv2/sample/history.rs:16-190) ---------------------------------------

# state kinds
MATCH, INS, DEL, MATCH_BEGIN, INS_BEGIN, END = "M", "I", "D", "MB", "IB", "E"

NO_EMISSION = -1


@dataclass
class History:
    """Recorded (state, emission) walk of the PHMM — the generative ground
    truth behind a sampled read (ref: history.rs:16 History).

    ``steps[t] = (kind, node, emission)`` where kind is one of
    M/I/D/MB/IB/E, node is the PHMM node index (-1 for begin/end states) and
    emission is the emitted base byte or NO_EMISSION."""

    steps: List[Tuple[str, int, int]]

    def __len__(self) -> int:
        return len(self.steps)

    def total_bases(self) -> int:
        return sum(1 for _k, _v, e in self.steps if e != NO_EMISSION)

    def to_sequence(self) -> bytes:
        """Emitted read (ref: history.rs:50-60 to_sequence)."""
        return bytes(e for _k, _v, e in self.steps if e != NO_EMISSION)

    def to_node_freqs(self, n_nodes: int) -> np.ndarray:
        """Usage count per PHMM node over all M/I/D states — the generative
        oracle for posterior node freqs (ref: history.rs:63-77)."""
        nf = np.zeros(n_nodes)
        for _k, v, _e in self.steps:
            if v >= 0:
                nf[v] += 1.0
        return nf

    def to_trans_counts(self, model) -> np.ndarray:
        """Usage count per (node, child-slot) transition, matching the
        layout of ``model.child_idx`` (ref: history.rs:80-100
        to_edge_freqs).  Self transitions (M(v)->I(v)) are not edges."""
        counts = np.zeros(model.child_idx.shape)
        prev = -1
        for _k, v, _e in self.steps:
            if v >= 0 and prev >= 0 and v != prev:
                slots = np.flatnonzero(model.child_idx[prev] == v)
                assert slots.size, (prev, v)
                counts[prev, slots[0]] += 1.0
            prev = v
        return counts


def _pick_weighted(rng: np.random.Generator, items, weights) -> int:
    """Index into items by normalized weights (ref: picker.rs:10-15)."""
    w = np.asarray(weights, dtype=np.float64)
    s = w.sum()
    if s <= 0:
        return -1
    return int(rng.choice(len(items), p=w / s))


def sample_history(
    model,
    rng: np.random.Generator,
    max_states: int,
    endable: bool = True,
    start_node: Optional[int] = None,
) -> History:
    """Generative walk of the PHMM itself — states are graph nodes, so the
    recorded History is the oracle for posterior node/edge frequencies
    (ref: sample.rs:231-330 sample_rng_from / make_transition /
    make_emission; picker.rs).

    ``model`` is the array-form PHMMModel (emission / init_logp /
    child_idx / child_logt).  ``start_node`` forces the first transition
    from MatchBegin to Match(start_node) (ref: sample.rs:246-259
    sample_rng_from_nodes)."""
    params = model.params
    p_end = params.p_end if endable else 0.0
    init_p = np.exp(model.init_logp)
    steps: List[Tuple[str, int, int]] = []

    def pick_init_node() -> int:
        if start_node is not None:
            return start_node
        s = init_p.sum()
        if s <= 0:
            return -1
        return int(rng.choice(init_p.shape[0], p=init_p / s))

    def pick_child(v: int) -> int:
        probs = np.exp(model.child_logt[v])
        j = _pick_weighted(rng, probs, probs)
        return int(model.child_idx[v, j]) if j >= 0 else -1

    def emit(kind: str, v: int) -> int:
        if kind == MATCH:
            b = int(model.emission[v])
            # ref: picker.rs:32-43 pick_match_emission — weights p_match for
            # the node base, p_mismatch for the other three, normalized
            weights = [
                params.p_match if c == b else params.p_mismatch
                for c in range(4)
            ]
            code = _pick_weighted(rng, weights, weights)
            return int(BASES[code])
        if kind in (INS, INS_BEGIN):
            return int(BASES[int(rng.integers(0, 4))])
        return NO_EMISSION

    def transition(kind: str, v: int) -> Tuple[str, int]:
        """(ref: sample.rs:336-419 make_transition)"""
        if kind in (MATCH, INS, DEL):
            child = pick_child(v)
            if child < 0:
                return END, -1
            stay = v if kind != DEL else v  # I stays on current node
            if kind == MATCH:
                choices = [(MATCH, child, params.p_MM), (INS, stay, params.p_MI),
                           (DEL, child, params.p_MD), (END, -1, p_end)]
            elif kind == INS:
                choices = [(MATCH, child, params.p_IM), (INS, stay, params.p_II),
                           (DEL, child, params.p_ID), (END, -1, p_end)]
            else:
                choices = [(MATCH, child, params.p_DM), (INS, stay, params.p_DI),
                           (DEL, child, params.p_DD), (END, -1, p_end)]
        elif kind == MATCH_BEGIN:
            node = pick_init_node()
            if node < 0:
                return END, -1
            choices = [(INS_BEGIN, -1, params.p_MI), (MATCH, node, params.p_MM),
                       (DEL, node, params.p_MD)]
        elif kind == INS_BEGIN:
            node = pick_init_node()
            if node < 0:
                return END, -1
            choices = [(INS_BEGIN, -1, params.p_II), (MATCH, node, params.p_IM),
                       (DEL, node, params.p_ID)]
        else:
            raise AssertionError(kind)
        j = _pick_weighted(rng, choices, [c[2] for c in choices])
        return choices[j][0], choices[j][1]

    kind, v = MATCH_BEGIN, -1
    for _ in range(max_states):
        kind, v = transition(kind, v)
        steps.append((kind, v, emit(kind, v)))
        if kind == END:
            break
    return History(steps)


def sample_histories(
    model,
    n_reads: int,
    max_states: int,
    seed: int = 0,
    endable: bool = True,
) -> List[History]:
    """(ref: sample.rs:175-185 sample_many)"""
    rng = np.random.Generator(np.random.PCG64(seed))
    return [
        sample_history(model, rng, max_states, endable=endable)
        for _ in range(n_reads)
    ]


# -- genome graph -> PHMM + positioned-read sampling
#    (ref: src/graph/genome_graph.rs:328-424) -----------------------------------


@dataclass
class SeqGraphMeta:
    """Per-PHMM-node ground-truth provenance of the genome seq graph."""

    hap: np.ndarray  # haplotype id per node
    pos: np.ndarray  # position in ORIGINAL haplotype coordinates
    is_revcomp: np.ndarray  # bool per node
    heads: List[int]  # chain head node per (hap, strand), fwd first


def genome_to_seq_phmm(
    genome_seqs: List[bytes],
    params: PHMMParams,
    has_revcomp: bool = False,
):
    """Per-base sequence graph of the genome (one node per base, plus a
    reverse-complement chain per haplotype when ``has_revcomp``) converted
    to a PHMM — the counterpart of
    ``GenomeGraph::to_seq_graph_with_revcomp().to_phmm()``
    (ref: genome_graph.rs:328-398).  Returns (PHMMModel, SeqGraphMeta)."""
    from ..graph.digraph import DiGraph
    from .model import seq_graph_to_phmm

    g = DiGraph()
    hap, pos, rc, heads = [], [], [], []
    for h, seq in enumerate(genome_seqs):
        chains = [(seq, False)]
        if has_revcomp:
            chains.append((revcomp(seq), True))
        for s, is_rc in chains:
            prev = None
            for i in range(len(s)):
                v = g.add_node((s[i], 1))
                hap.append(h)
                pos.append(len(s) - 1 - i if is_rc else i)
                rc.append(is_rc)
                if prev is None:
                    heads.append(v)
                else:
                    g.add_edge(prev, v, None)
                prev = v
    model = seq_graph_to_phmm(g, params, mode="normal")
    meta = SeqGraphMeta(
        hap=np.asarray(hap), pos=np.asarray(pos),
        is_revcomp=np.asarray(rc, dtype=bool), heads=heads,
    )
    return model, meta


def history_to_positioned_read(
    history: History, meta: SeqGraphMeta
) -> PositionedSequence:
    """Emitted read + per-base ground-truth origins from a History walk
    (ref: history.rs:102-190 to_positioned_sequence)."""
    out = bytearray()
    origins: List[GenomeGraphPos] = []
    is_rc = False
    seen_node = False
    for kind, v, e in history.steps:
        if v >= 0 and not seen_node:
            is_rc = bool(meta.is_revcomp[v])
            seen_node = True
        if e == NO_EMISSION:
            continue
        out.append(e)
        if kind == MATCH:
            origins.append(GenomeGraphPos(int(meta.hap[v]), int(meta.pos[v])))
        else:  # Ins / InsBegin
            origins.append(GenomeGraphPos())
    return PositionedSequence(bytes(out), origins, is_revcomp=is_rc)


def sample_positioned_reads_phmm(
    genome_seqs: List[bytes],
    params: PHMMParams,
    profile: SampleProfile,
    has_revcomp: bool = False,
) -> List[PositionedSequence]:
    """Positioned-read sampling by walking the genome-graph PHMM itself —
    the reference's generative path (ref: genome_graph.rs:399-424
    sample_positioned_reads; e2e.rs:163-240), replacing the haplotype-string
    walk with a true graph-PHMM walk whose History carries provenance."""
    model, meta = genome_to_seq_phmm(genome_seqs, params, has_revcomp)
    rng = np.random.Generator(np.random.PCG64(profile.seed))
    lengths = np.array([len(s) for s in genome_seqs], dtype=np.float64)
    p_hap = lengths / lengths.sum()
    strands = 2 if has_revcomp else 1

    def one_read() -> PositionedSequence:
        start_node = None
        if profile.start_points_all:
            hap_i = int(rng.choice(len(genome_seqs), p=p_hap))
            strand = int(rng.integers(0, strands))
            start_node = meta.heads[hap_i * strands + strand]
        h = sample_history(
            model, rng, max_states=profile.length, endable=profile.endable,
            start_node=start_node,
        )
        return history_to_positioned_read(h, meta)

    reads: List[PositionedSequence] = []
    total = 0
    if profile.n_reads is not None:
        for _ in range(profile.n_reads):
            reads.append(one_read())
    else:
        assert profile.total_bases is not None
        while total < profile.total_bases:
            r = one_read()
            if len(r) == 0:
                continue
            reads.append(r)
            total += len(r)
    return reads
