"""Sequences, styles and read collections.

Counterpart of the reference's sequence data model
(ref: src/common.rs:19-41, src/common/collection.rs).

Sequences are Python ``bytes`` over the alphabet {A, C, G, T} plus the null
base ``n`` used for terminal padding k-mers.  Reads are stored in a
``ReadCollection``; simulated reads carry their ground-truth origin in a
``PositionedSequence``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

BASES = b"ACGT"
NULL_BASE = ord(b"n")  # ref: src/common.rs NULL_BASE = 'n'

_COMP = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")

_VALID = set(b"ACGT") | {NULL_BASE}


def sanitize_bases(seq: bytes) -> bytes:
    """Uppercase and validate bases (ref: collection.rs sanitize_bases)."""
    out = seq.upper().replace(b"N", b"n")
    for b in out:
        if b not in _VALID:
            raise ValueError(f"invalid base {chr(b)!r} in sequence")
    return out


def revcomp(seq: bytes) -> bytes:
    """Reverse complement."""
    return seq.translate(_COMP)[::-1]


def sequence_to_string(seq: bytes) -> str:
    return seq.decode("ascii")


class SeqStyle(enum.Enum):
    """Sequence topology (ref: collection.rs:331 SeqStyle)."""

    LINEAR = "L"
    CIRCULAR = "C"
    LINEAR_FRAGMENT = "F"

    def has_prefix(self) -> bool:
        """True if the sequence starts at a real genome end (needs 'nnn' margin
        k-mers when building the DBG)."""
        return self is SeqStyle.LINEAR

    def has_suffix(self) -> bool:
        """Linear ends with 'nnn' margins; circular wraps around
        (ref: collection.rs:354-359)."""
        return self in (SeqStyle.LINEAR, SeqStyle.CIRCULAR)

    def is_circular(self) -> bool:
        return self is SeqStyle.CIRCULAR


@dataclass
class StyledSequence:
    """A sequence tagged with its topology; serialized as ``"L:ACGT"``
    (ref: collection.rs:398-467)."""

    seq: bytes
    style: SeqStyle = SeqStyle.LINEAR

    def __post_init__(self):
        if isinstance(self.seq, str):
            self.seq = self.seq.encode("ascii")
        self.seq = bytes(self.seq)

    @staticmethod
    def linear(seq: bytes) -> "StyledSequence":
        return StyledSequence(seq, SeqStyle.LINEAR)

    @staticmethod
    def circular(seq: bytes) -> "StyledSequence":
        return StyledSequence(seq, SeqStyle.CIRCULAR)

    @staticmethod
    def fragment(seq: bytes) -> "StyledSequence":
        return StyledSequence(seq, SeqStyle.LINEAR_FRAGMENT)

    def __len__(self) -> int:
        return len(self.seq)

    def __str__(self) -> str:
        return f"{self.style.value}:{self.seq.decode('ascii')}"

    @staticmethod
    def from_str(s: str) -> "StyledSequence":
        style_str, _, seq = s.partition(":")
        style = SeqStyle(style_str)
        return StyledSequence(seq.encode("ascii"), style)

    def to_json(self) -> str:
        return str(self)


@dataclass
class GenomeGraphPos:
    """Origin of a sampled base: either a position on a genome haplotype
    (Match) or None (Ins) (ref: src/graph/genome_graph.rs GenomeGraphPos)."""

    haplotype: Optional[int] = None
    pos: Optional[int] = None

    def is_match(self) -> bool:
        return self.haplotype is not None

    def __str__(self) -> str:
        if self.is_match():
            return f"M{self.haplotype}:{self.pos}"
        return "I"

    @staticmethod
    def from_str(s: str) -> "GenomeGraphPos":
        if s == "I":
            return GenomeGraphPos()
        hap, _, pos = s[1:].partition(":")
        return GenomeGraphPos(int(hap), int(pos))


@dataclass
class PositionedSequence:
    """A simulated read together with per-base ground-truth origins
    (ref: collection.rs:508-726 PositionedSequence)."""

    seq: bytes
    origins: List[GenomeGraphPos]
    is_revcomp: bool = False

    def __post_init__(self):
        self.seq = bytes(self.seq)

    def __len__(self) -> int:
        return len(self.seq)

    def head_origin(self) -> GenomeGraphPos:
        for o in self.origins:
            if o.is_match():
                return o
        return GenomeGraphPos()

    def tail_origin(self) -> GenomeGraphPos:
        for o in reversed(self.origins):
            if o.is_match():
                return o
        return GenomeGraphPos()

    def justify_strand(self) -> "PositionedSequence":
        """Flip to forward strand if sampled from the reverse-complement copy
        (ref: collection.rs:295 justify_strand)."""
        if not self.is_revcomp:
            return self
        return PositionedSequence(
            revcomp(self.seq), list(reversed(self.origins)), is_revcomp=False
        )


class ReadCollection:
    """Container of reads (ref: collection.rs:131-260).

    Stores plain byte-sequences; when constructed from simulation, also keeps
    the full :class:`PositionedSequence` records for ground-truth checks.
    """

    def __init__(
        self,
        reads: Sequence[bytes],
        positioned: Optional[Sequence[PositionedSequence]] = None,
    ):
        self.reads: List[bytes] = [bytes(r) for r in reads]
        self.positioned: Optional[List[PositionedSequence]] = (
            list(positioned) if positioned is not None else None
        )

    @staticmethod
    def from_positioned(reads: Sequence[PositionedSequence]) -> "ReadCollection":
        return ReadCollection([r.seq for r in reads], positioned=list(reads))

    def __len__(self) -> int:
        return len(self.reads)

    def __iter__(self) -> Iterator[bytes]:
        return iter(self.reads)

    def __getitem__(self, i: int) -> bytes:
        return self.reads[i]

    def total_bases(self) -> int:
        return sum(len(r) for r in self.reads)

    def average_length(self) -> float:
        return self.total_bases() / len(self.reads) if self.reads else 0.0

    def coverage(self, genome_size: int) -> float:
        return self.total_bases() / genome_size if genome_size else 0.0

    # -- FASTA I/O ------------------------------------------------------------

    def to_fasta(self, path) -> None:
        from .io import write_fasta

        write_fasta(path, [(f"r{i}", None, r) for i, r in enumerate(self.reads)])

    @staticmethod
    def from_fasta(path) -> "ReadCollection":
        from .io import parse_fasta

        return ReadCollection([seq for _, _, seq in parse_fasta(path)])

    # -- SAM/PAF-ish ground-truth export (ref: collection.rs:622-724) ---------

    def to_paf_lines(self, genome_lens: Optional[List[int]] = None) -> List[str]:
        """PAF export of simulated read origins (ref: collection.rs:622-660
        to_paf): qname qlen qstart qend strand tname tlen tstart tend
        n_match aln_len mapq."""
        lines = []
        if self.positioned is None:
            return lines
        for i, pr in enumerate(self.positioned):
            head = pr.head_origin()
            tail = pr.tail_origin()
            if not head.is_match():
                continue
            hap = head.haplotype
            tlen = genome_lens[hap] if genome_lens else 0
            tstart, tend = sorted((head.pos, tail.pos))
            n_match = sum(1 for o in pr.origins if o.is_match())
            strand = "-" if pr.is_revcomp else "+"
            lines.append(
                f"r{i}\t{len(pr.seq)}\t0\t{len(pr.seq)}\t{strand}\tg{hap}\t"
                f"{tlen}\t{tstart}\t{tend + 1}\t{n_match}\t{len(pr.seq)}\t60"
            )
        return lines

    def to_sam_lines(self, genome_names: Optional[List[str]] = None) -> List[str]:
        """Minimal SAM-like export of simulated read origins."""
        lines = []
        if self.positioned is None:
            return lines
        for i, pr in enumerate(self.positioned):
            head = pr.head_origin()
            flag = 16 if pr.is_revcomp else 0
            rname = (
                f"g{head.haplotype}" if head.is_match() else "*"
                if genome_names is None
                else genome_names[head.haplotype or 0]
            )
            pos = (head.pos or 0) + 1 if head.is_match() else 0
            lines.append(
                f"r{i}\t{flag}\t{rname}\t{pos}\t255\t{len(pr.seq)}M\t*\t0\t0\t"
                f"{pr.seq.decode('ascii')}\t*"
            )
        return lines
