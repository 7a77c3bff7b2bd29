"""Random sequence generation and mutation ops.

Counterpart of the reference's random_seq module (ref: src/random_seq.rs:9-120).
Uses numpy's PCG64 generator; seeds are deterministic within this framework
(bit-compatibility of PRNG streams with the Rust Xoshiro256++ is not a goal --
the ground-truth harness carries its own truth labels).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .collection import BASES

_BASE_ARR = np.frombuffer(BASES, dtype=np.uint8)


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed))


def generate(length: int, seed: int) -> bytes:
    """Random ACGT sequence of given length (ref: random_seq.rs generate)."""
    if length == 0:
        return b""
    r = _rng(seed)
    return _BASE_ARR[r.integers(0, 4, size=length)].tobytes()


def tandem_repeat(unit: bytes, n_unit: int) -> bytes:
    """Repeat the unit n times (ref: random_seq.rs tandem_repeat)."""
    return bytes(unit) * n_unit


def join(a: bytes, b: bytes) -> bytes:
    return bytes(a) + bytes(b)


@dataclass
class MutationProfile:
    """Per-base mutation probabilities (ref: random_seq.rs MutationProfile)."""

    p_mut: float
    p_ins: float
    p_del: float

    @staticmethod
    def uniform(p: float) -> "MutationProfile":
        return MutationProfile(p_mut=p, p_ins=p, p_del=p)


@dataclass
class EditOp:
    """One applied edit, for debug/ground-truth output."""

    kind: str  # 'mut' | 'ins' | 'del'
    pos: int
    base: str = ""

    def __repr__(self) -> str:
        return f"{self.kind}@{self.pos}{self.base}"


def random_mutation_with_rng(
    seq: bytes, profile: MutationProfile, rng: np.random.Generator
) -> Tuple[bytes, List[EditOp]]:
    """Apply random per-base substitutions / insertions / deletions
    (ref: random_seq.rs random_mutation)."""
    out = bytearray()
    ops: List[EditOp] = []
    for i, b in enumerate(seq):
        u = rng.random()
        if u < profile.p_mut:
            # substitute with one of the 3 other bases
            others = [c for c in BASES if c != b]
            nb = others[rng.integers(0, 3)]
            out.append(nb)
            ops.append(EditOp("mut", i, chr(nb)))
        elif u < profile.p_mut + profile.p_del:
            ops.append(EditOp("del", i))
            continue
        elif u < profile.p_mut + profile.p_del + profile.p_ins:
            nb = int(_BASE_ARR[rng.integers(0, 4)])
            out.append(nb)
            out.append(b)
            ops.append(EditOp("ins", i, chr(nb)))
        else:
            out.append(b)
    return bytes(out), ops


def random_mutation(
    seq: bytes, profile: MutationProfile, seed: int
) -> Tuple[bytes, List[EditOp]]:
    return random_mutation_with_rng(seq, profile, _rng(seed))
