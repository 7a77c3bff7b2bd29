"""Sequence / data model layer (ref: src/common/collection.rs, src/genome.rs)."""

from .collection import (  # noqa: F401
    BASES,
    NULL_BASE,
    PositionedSequence,
    ReadCollection,
    SeqStyle,
    StyledSequence,
    revcomp,
    sanitize_bases,
    sequence_to_string,
)
from .genome import Genome  # noqa: F401
from . import genome, random_seq  # noqa: F401
from .io import parse_fasta, write_fasta, open_maybe_gzip  # noqa: F401
