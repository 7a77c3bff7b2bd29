"""FASTA / gzip I/O helpers (ref: src/io.rs, src/io/fasta.rs)."""

from __future__ import annotations

import gzip
import io
from pathlib import Path
from typing import Iterable, List, Optional, Tuple


def open_maybe_gzip(path, mode: str = "rt"):
    """Open plain or .gz transparently (ref: src/io.rs:3-27 gzip helpers)."""
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def parse_fasta(path) -> List[Tuple[str, Optional[str], bytes]]:
    """Parse a FASTA file into (name, description, sequence) records
    (ref: src/io/fasta.rs:8 parse_seqs)."""
    records: List[Tuple[str, Optional[str], bytes]] = []
    name: Optional[str] = None
    desc: Optional[str] = None
    chunks: List[bytes] = []
    with open_maybe_gzip(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    records.append((name, desc, b"".join(chunks)))
                header = line[1:].split(None, 1)
                name = header[0]
                desc = header[1] if len(header) > 1 else None
                chunks = []
            else:
                chunks.append(line.encode("ascii"))
    if name is not None:
        records.append((name, desc, b"".join(chunks)))
    return records


def write_fasta(path, records: Iterable[Tuple[str, Optional[str], bytes]], width: int = 80):
    """Write FASTA records (name, description, sequence)."""
    with open_maybe_gzip(path, "wt") as f:
        for name, desc, seq in records:
            header = f">{name}" + (f" {desc}" if desc else "")
            f.write(header + "\n")
            s = seq.decode("ascii") if isinstance(seq, (bytes, bytearray)) else seq
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")
