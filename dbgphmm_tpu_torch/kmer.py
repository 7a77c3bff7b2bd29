"""K-mer utilities over plain ``bytes``.

Counterpart of the reference's KmerLike trait family
(ref: src/kmer/common.rs:7-250, src/kmer/veckmer.rs).  A k-mer is simply a
``bytes`` object of length k over {A,C,G,T,n}; helper functions replace trait
methods.  The null base 'n' marks terminal margins: linear sequences produce
``nnnA..``/``..Gnnn`` padding k-mers so genome ends become explicit paths
through the terminal node in the DBG.
"""

from __future__ import annotations

from typing import Iterator, List

from .seq.collection import NULL_BASE, SeqStyle, StyledSequence

BASES = b"ACGT"
_N = bytes([NULL_BASE])


# -- basic accessors (ref: kmer/common.rs:23-120) -----------------------------


def prefix(kmer: bytes) -> bytes:
    """First k-1 bases."""
    return kmer[:-1]


def suffix(kmer: bytes) -> bytes:
    """Last k-1 bases."""
    return kmer[1:]


def childs(kmer: bytes) -> List[bytes]:
    """All k-mers whose prefix equals this k-mer's suffix."""
    s = suffix(kmer)
    return [s + bytes([b]) for b in BASES] + [s + _N]


def parents(kmer: bytes) -> List[bytes]:
    """All k-mers whose suffix equals this k-mer's prefix."""
    p = prefix(kmer)
    return [bytes([b]) + p for b in BASES] + [_N + p]


def siblings(kmer: bytes) -> List[bytes]:
    """k-mers sharing this one's prefix."""
    p = prefix(kmer)
    return [p + bytes([b]) for b in BASES] + [p + _N]


def is_adjacent(a: bytes, b: bytes) -> bool:
    """a -> b is a valid DBG edge (suffix(a) == prefix(b))."""
    return suffix(a) == prefix(b)


def extend_first(kmer: bytes, base: int) -> bytes:
    """(k+1)-mer by prepending a base."""
    return bytes([base]) + kmer


def extend_last(kmer: bytes, base: int) -> bytes:
    """(k+1)-mer by appending a base."""
    return kmer + bytes([base])


def overlap(a: bytes, b: bytes) -> bytes:
    """Join adjacent k-mers into a (k+1)-mer: a=XY..., b=Y...Z -> XY...Z."""
    assert is_adjacent(a, b)
    return a + b[-1:]


def is_null(kmer: bytes) -> bool:
    """All-'n' terminal k-mer."""
    return all(b == NULL_BASE for b in kmer)


def is_starting(kmer: bytes) -> bool:
    """'nnn..nX' shape: only the last base is non-null (ref: NullableKmer)."""
    return (
        len(kmer) >= 1
        and kmer[-1] != NULL_BASE
        and all(b == NULL_BASE for b in kmer[:-1])
    )


def is_ending(kmer: bytes) -> bool:
    """'Xnn..nn' shape: only the first base is non-null."""
    return (
        len(kmer) >= 1
        and kmer[0] != NULL_BASE
        and all(b == NULL_BASE for b in kmer[1:])
    )


def has_null(kmer: bytes) -> bool:
    return NULL_BASE in kmer


def emission(kmer: bytes) -> int:
    """The base emitted by this k-mer in the PHMM = its last base."""
    return kmer[-1]


def is_emittable(kmer: bytes) -> bool:
    return kmer[-1] != NULL_BASE


# -- sequence -> k-mer streams (ref: kmer/common.rs:251-366) ------------------


def sequence_to_kmers(seq: bytes, k: int, style: SeqStyle) -> Iterator[bytes]:
    """Yield k-mers of a styled sequence with terminal margins:

    * Linear:   ``n^(k-1) x[0]``, ..., body k-mers, ..., ``x[-1] n^(k-1)``
    * Circular: body k-mers then wrap-around k-mers
    * Fragment: body k-mers only
    """
    l = len(seq)
    if style.has_prefix():
        for i in range(k - 1):
            n_pre = k - 1 - i
            yield _N * n_pre + seq[: k - n_pre]
    if l >= k:
        for i in range(l - k + 1):
            yield seq[i : i + k]
    if style.has_suffix():
        for i in range(k - 1):
            n_suf = i + 1
            body = seq[l - (k - n_suf) :]
            if style.is_circular():
                yield body + seq[:n_suf]
            else:
                yield body + _N * n_suf


def linear_sequence_to_kmers(seq: bytes, k: int) -> Iterator[bytes]:
    return sequence_to_kmers(seq, k, SeqStyle.LINEAR)


def linear_fragment_sequence_to_kmers(seq: bytes, k: int) -> Iterator[bytes]:
    return sequence_to_kmers(seq, k, SeqStyle.LINEAR_FRAGMENT)


def circular_sequence_to_kmers(seq: bytes, k: int) -> Iterator[bytes]:
    return sequence_to_kmers(seq, k, SeqStyle.CIRCULAR)


def styled_sequence_to_kmers(s: StyledSequence, k: int) -> Iterator[bytes]:
    return sequence_to_kmers(s.seq, k, s.style)


def kmers_to_string(kmers: List[bytes]) -> str:
    return ",".join(km.decode("ascii") for km in kmers)


def kmers_join(kmers: List[bytes]) -> bytes:
    """["ATC","TCG","CGT"] -> "ATCGT" (ref: kmer/common.rs kmers_join)."""
    if not kmers:
        return b""
    out = bytearray(kmers[0])
    for km in kmers[1:]:
        out.append(km[-1])
    return bytes(out)
