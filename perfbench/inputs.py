"""A cell's inputs from its configuration and ``--seed``: the frozen genome
and draft under ``perfbench/data/<config>/`` and a read set sampled from
the genome.

The sampler is the benchmark's own (the program's is not used, so that a
change to the program cannot change the inputs); it follows the upstream
sampler's rule (:func:`reads`).  The seed picks the haplotypes, start
points, early ends and errors, so read sets differ a little in count and
lengths and hold the same coverage.  A run draws one read set per unit of
traffic, so that its window averages over several.  A read copies its template base by
base: with probability p a substitution, with p an insertion of a random
base before it, with p a deletion (the uniform error model of the upstream
simulator, ``PHMMParams.uniform(p)``).  Reads are on the genome's strand,
as the upstream simulator leaves them after ``justify_strand``.
"""

from __future__ import annotations

import gzip
import math
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parent  # configuration paths are under it


def genome(cfg: dict, root: Path = ROOT) -> List[bytes]:
    """The haplotypes (the styled sequences' bases, 'L:' stripped)."""
    lines = (root / cfg["dataset"]["genome"]).read_text().split()
    return [s.split(":", 1)[1].encode() for s in lines]


def draft_text(cfg: dict, root: Path = ROOT) -> str:
    """The k-mer draft in the program's DBG text format."""
    with gzip.open(root / cfg["dataset"]["draft"], "rt") as f:
        return f.read()


def _mutate(t: bytes, p: float, rng: np.random.Generator) -> bytes:
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.searchsorted(acgt, np.frombuffer(t, dtype=np.uint8))
    n = len(t)
    u = rng.random((n, 3))
    shift = rng.integers(1, 4, n)  # a substitution takes another base
    base = acgt[np.where(u[:, 0] < p, (code + shift) % 4, code)]
    ins_base = acgt[rng.integers(0, 4, n)]
    # per template base: an inserted base before it, then the base unless
    # it is deleted
    pair = np.stack([ins_base, base], axis=1)
    keep = np.stack([u[:, 1] < p, u[:, 2] >= p], axis=1)
    return pair[keep].tobytes()


def reads(cfg: dict, seed: int, index: int = 0,
          root: Path = ROOT) -> List[bytes]:
    """Read set ``index`` of ``seed`` (config key ``reads``), by the
    upstream sampler's rule (``sample_positioned_reads``): each read takes a
    haplotype drawn in proportion to its length and starts at its first
    base (``full_length``) or at a uniform position of it (``fragment``);
    it runs ``read_length`` bases (``full_length``: the whole haplotype),
    cut at the haplotype's end and, with probability ``p_end`` a base, before
    it; empty reads (and, departing from the upstream rule, reads shorter
    than ``min_length``) are dropped, and reads are drawn until they hold
    ``coverage`` x the genome's bases."""
    spec = cfg["dataset"]["reads"]
    haps = genome(cfg, root)
    lens = np.asarray([len(h) for h in haps], dtype=np.float64)
    total = math.ceil(lens.sum() * float(spec["coverage"]))
    p, p_end = float(spec["p_error"]), float(spec.get("p_end", 1e-5))
    if spec["kind"] not in ("full_length", "fragment"):
        raise ValueError(f"unknown read kind {spec['kind']!r}")
    whole = spec["kind"] == "full_length"
    min_len = max(1, int(spec.get("min_length", 1)))
    L = None if whole else int(spec["read_length"])
    rng = np.random.default_rng([int(seed), int(index)])
    out, got = [], 0
    while got < total:
        h = int(rng.choice(len(haps), p=lens / lens.sum()))
        s = 0 if whole else int(rng.integers(0, len(haps[h])))
        t = len(haps[h]) if whole else min(len(haps[h]), s + L)
        t = min(t, s + int(rng.geometric(p_end)) - 1)
        if t <= s:
            continue
        r = _mutate(haps[h][s:t], p, rng)
        if len(r) >= min_len:
            out.append(r)
            got += len(r)
    return out
