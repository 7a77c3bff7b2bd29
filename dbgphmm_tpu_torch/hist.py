"""Histogram and discrete posterior distributions
(ref: src/hist.rs:38-176 Hist / DiscreteDistribution).

Used for per-edge copy-number posteriors `P(X(e)=x | R)` in INSPECT/GFA
outputs and for k-mer count statistics.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from .prob import NEG_INF, ladd


class Hist:
    """Empirical integer histogram (ref: hist.rs:38)."""

    def __init__(self):
        self.counts: Dict[int, int] = {}

    def add(self, x: int, n: int = 1) -> None:
        self.counts[x] = self.counts.get(x, 0) + n

    def get(self, x: int) -> int:
        return self.counts.get(x, 0)

    def total(self) -> int:
        return sum(self.counts.values())

    def mean(self) -> float:
        t = self.total()
        if t == 0:
            return 0.0
        return sum(x * c for x, c in self.counts.items()) / t

    def __str__(self) -> str:
        return ",".join(f"{x}:{c}" for x, c in sorted(self.counts.items()))


class DiscreteDistribution:
    """Normalized distribution over integers, stored as log probs
    (ref: hist.rs:113-176)."""

    def __init__(self, logp: Dict[int, float]):
        z = NEG_INF
        for lp in logp.values():
            z = ladd(z, lp)
        self.logp = {x: lp - z for x, lp in logp.items()}

    @staticmethod
    def from_occurs(occurs: Iterable[Tuple[int, float]]) -> "DiscreteDistribution":
        """From (value, log prob) pairs; duplicate values are log-added."""
        acc: Dict[int, float] = {}
        for x, lp in occurs:
            acc[x] = ladd(acc.get(x, NEG_INF), lp)
        return DiscreteDistribution(acc)

    def p_x(self, x: int) -> float:
        """Linear-space probability of x."""
        return math.exp(self.logp.get(x, NEG_INF))

    def mean(self) -> float:
        return sum(x * math.exp(lp) for x, lp in self.logp.items())

    def to_short_string(self) -> str:
        """``p(1)=0.900,p(2)=0.100`` (ref: hist.rs:81-87)."""
        return ",".join(
            f"p({x})={math.exp(self.logp[x]):.3f}" for x in sorted(self.logp)
        )

    def argmax(self) -> int:
        return max(self.logp, key=lambda x: self.logp[x])
