"""Hand-built toy MultiDbg fixtures (ref: src/multi_dbg/toy.rs:32-560).

These mirror the reference's named test graphs; built from their defining
sequences (behaviorally identical — the reference hand-wires the same
graphs edge by edge).
"""

from __future__ import annotations

from ..seq.collection import StyledSequence
from . import MultiDbg


def circular() -> MultiDbg:
    """k=4 circular GATCC (ref: toy.rs circular)."""
    return MultiDbg.from_styled_seqs(4, [StyledSequence.circular(b"GATCC")])


def linear() -> MultiDbg:
    """k=4 linear GATCC with terminal margins (ref: toy.rs linear)."""
    return MultiDbg.from_styled_seqs(4, [StyledSequence.linear(b"GATCC")])


def linear_long() -> MultiDbg:
    return MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(b"GATCCTTGATGTCCTAGCAA")]
    )


def intersection() -> MultiDbg:
    """Two sequences crossing at a shared (k-1)-mer (ref: toy.rs
    intersection): X-shaped graph."""
    return MultiDbg.from_styled_seqs(
        4, [StyledSequence.linear(b"AACTAGCTT"), StyledSequence.linear(b"GGCTAGCGG")]
    )


def selfloop() -> MultiDbg:
    """Homopolymer run -> self-loop edge (ref: toy.rs selfloop)."""
    return MultiDbg.from_styled_seqs(4, [StyledSequence.linear(b"CTAAAAAAAGC")])


def repeat() -> MultiDbg:
    """Tandem repeat CCGCCG.. (ref: toy.rs repeat)."""
    return MultiDbg.from_styled_seqs(
        4, [StyledSequence.linear(b"TACCGCCGCCGCAGG")]
    )


def repeat_kp1() -> MultiDbg:
    return repeat().to_kp1_dbg()


def one_in_n_repeat(n: int) -> MultiDbg:
    """Unit repeated n times between unique ends."""
    return MultiDbg.from_styled_seqs(
        4, [StyledSequence.linear(b"TAGG" + b"CAGT" * n + b"ACCA")]
    )


def two_components() -> MultiDbg:
    """Disconnected graph with two linear components
    (ref: toy.rs two_components)."""
    return MultiDbg.from_styled_seqs(
        4,
        [StyledSequence.linear(b"GATCC"), StyledSequence.linear(b"TTAGG")],
    )


ALL = {
    "circular": circular,
    "linear": linear,
    "linear_long": linear_long,
    "intersection": intersection,
    "selfloop": selfloop,
    "repeat": repeat,
    "one_in_3_repeat": lambda: one_in_n_repeat(3),
    "two_components": two_components,
}
