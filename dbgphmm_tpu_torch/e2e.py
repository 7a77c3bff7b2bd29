"""End-to-end simulation harness: Dataset = genome + sampled reads + params
(ref: src/e2e.rs:33-260).

Reads are sampled *from the same PHMM error model* used in inference, with
per-base ground-truth origins, so posterior accuracy can be checked against
the embedded truth.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from .phmm.params import PHMMParams
from .phmm.sample import SampleProfile, sample_positioned_reads_phmm
from .seq.collection import PositionedSequence, ReadCollection, StyledSequence
from .seq.genome import Genome


class ReadType(enum.Enum):
    """(ref: e2e.rs:19-25)"""

    FULL_LENGTH_FOR_HAPLOID = "full_length_for_haploid"
    FULL_LENGTH = "full_length"
    FIXED_SIZE_FRAGMENT = "fixed_size_fragment"
    FRAGMENT_WITH_REVCOMP = "fragment_with_revcomp"
    FULL_LENGTH_WITH_REVCOMP = "full_length_with_revcomp"


@dataclass
class Dataset:
    """(ref: e2e.rs:33-160)"""

    genome: Genome
    reads: ReadCollection
    params: PHMMParams

    def genome_size(self) -> int:
        return self.genome.genome_size()

    def coverage(self) -> float:
        return self.reads.coverage(self.genome_size())

    def average_read_length(self) -> float:
        return self.reads.average_length()

    # -- JSON round trip (ref: e2e.rs:123-160) --------------------------------

    def to_json(self) -> str:
        obj = {
            "genome": [str(s) for s in self.genome],
            "genome_size": self.genome_size(),
            "reads": [r.decode("ascii") for r in self.reads],
            "phmm_params": json.loads(self.params.to_json()),
        }
        return json.dumps(obj)

    def to_json_file(self, path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def from_json(s: str) -> "Dataset":
        obj = json.loads(s)
        genome = Genome([StyledSequence.from_str(x) for x in obj["genome"]])
        reads = ReadCollection([r.encode("ascii") for r in obj["reads"]])
        params = PHMMParams(**obj["phmm_params"])
        return Dataset(genome, reads, params)

    @staticmethod
    def from_json_file(path) -> "Dataset":
        return Dataset.from_json(Path(path).read_text())

    # -- companion files ------------------------------------------------------

    def write_files(self, prefix: str) -> None:
        """dataset.json + genome.fa + reads.fa + reads.sam
        (ref: e2e.rs:123-160, bin/draft.rs)."""
        self.to_json_file(f"{prefix}.json")
        self.genome.to_fasta(f"{prefix}.genome.fa")
        self.reads.to_fasta(f"{prefix}.reads.fa")
        with open(f"{prefix}.reads.sam", "w") as f:
            for line in self.reads.to_sam_lines():
                f.write(line + "\n")


def generate_dataset(
    genome: Genome,
    read_seed: int,
    coverage: int,
    read_length: int,
    read_type: ReadType,
    phmm_params: PHMMParams,
) -> Dataset:
    """(ref: e2e.rs:163-240)"""
    genome_size = genome.genome_size()
    seqs = [s.seq for s in genome]

    if read_type in (ReadType.FULL_LENGTH_FOR_HAPLOID,):
        profile = SampleProfile(
            n_reads=coverage, length=read_length, start_points_all=True,
            seed=read_seed,
        )
        has_revcomp = False
    elif read_type is ReadType.FULL_LENGTH:
        profile = SampleProfile(
            total_bases=genome_size * coverage, length=read_length,
            start_points_all=True, seed=read_seed,
        )
        has_revcomp = False
    elif read_type is ReadType.FULL_LENGTH_WITH_REVCOMP:
        profile = SampleProfile(
            total_bases=genome_size * coverage, length=read_length,
            start_points_all=True, seed=read_seed,
        )
        has_revcomp = True
    elif read_type is ReadType.FIXED_SIZE_FRAGMENT:
        profile = SampleProfile(
            total_bases=genome_size * coverage, length=read_length,
            start_points_all=False, seed=read_seed,
        )
        has_revcomp = False
    else:  # FRAGMENT_WITH_REVCOMP
        profile = SampleProfile(
            total_bases=genome_size * coverage, length=read_length,
            start_points_all=False, seed=read_seed,
        )
        has_revcomp = True

    # reads are sampled by walking the genome-graph PHMM itself (the
    # reference's generative path, e2e.rs:163-240 via genome_graph.rs:399)
    pos_reads = sample_positioned_reads_phmm(
        seqs, phmm_params, profile, has_revcomp
    )
    pos_reads = [r.justify_strand() for r in pos_reads]
    reads = ReadCollection.from_positioned(pos_reads)
    return Dataset(genome=genome, reads=reads, params=phmm_params)


def generate_simple_genome_fragment_dataset() -> Dataset:
    """200bp genome, 20x 50bp fragment reads, p=0.1%
    (ref: e2e.rs generate_simple_genome_fragment_dataset)."""
    from .seq import genome as genome_gen

    return generate_dataset(
        genome_gen.simple(200, 5),
        0,
        20,
        50,
        ReadType.FRAGMENT_WITH_REVCOMP,
        PHMMParams.uniform(0.001),
    )


def generate_small_tandem_repeat_dataset() -> Dataset:
    """(ref: e2e.rs generate_small_tandem_repeat)"""
    from .seq import genome as genome_gen

    g = genome_gen.tandem_repeat_polyploid_with_unique_homo_ends(
        20, 20, 0, 0.02, 1, 100, 2, 0.02, 0
    )
    return generate_dataset(
        g, 0, 20, 1000, ReadType.FULL_LENGTH_WITH_REVCOMP, PHMMParams.uniform(0.001)
    )
