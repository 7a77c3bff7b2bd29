"""Genome container + synthetic genome generators.

Counterpart of the reference's genome module (ref: src/genome.rs:23-434).
Provides the same family of generators (simple / diploid / tandem-repeat
polyploid with unique homo ends) used by the simulation harness.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .collection import SeqStyle, StyledSequence
from .random_seq import (
    MutationProfile,
    generate,
    join,
    random_mutation,
    random_mutation_with_rng,
    tandem_repeat,
)


class Genome:
    """Collection of haplotype sequences (ref: src/genome.rs:23)."""

    def __init__(self, seqs: List[StyledSequence]):
        self.seqs = list(seqs)

    def __len__(self) -> int:
        return len(self.seqs)

    def __getitem__(self, i: int) -> StyledSequence:
        return self.seqs[i]

    def __iter__(self):
        return iter(self.seqs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Genome) and self.seqs == other.seqs

    def n_linear_haplotypes(self) -> int:
        return sum(1 for s in self.seqs if s.style is SeqStyle.LINEAR)

    def genome_size(self) -> int:
        return sum(len(s) for s in self.seqs)

    def to_kmers(self, k: int) -> Dict[bytes, int]:
        """k-mer occurrence table incl. 'n'-margin k-mers
        (ref: genome.rs:100 to_kmers)."""
        from ..kmer import styled_sequence_to_kmers

        hm: Dict[bytes, int] = {}
        for s in self.seqs:
            for kmer in styled_sequence_to_kmers(s, k):
                hm[kmer] = hm.get(kmer, 0) + 1
        return hm

    # -- FASTA round trip (ref: genome.rs:61-98) ------------------------------

    def to_fasta(self, path) -> None:
        from .io import write_fasta

        write_fasta(
            path,
            [(f"g{i}", s.style.value, s.seq) for i, s in enumerate(self.seqs)],
        )

    @staticmethod
    def from_fasta(path) -> "Genome":
        from .io import parse_fasta
        from .collection import sanitize_bases

        seqs = []
        for _name, desc, seq in parse_fasta(path):
            style = SeqStyle.CIRCULAR if desc == "C" else SeqStyle.LINEAR
            seqs.append(StyledSequence(sanitize_bases(seq), style))
        return Genome(seqs)


# -- generators (ref: src/genome.rs:140-434) ----------------------------------


def simple(genome_size: int, seed: int) -> Genome:
    return Genome([StyledSequence.linear(generate(genome_size, seed))])


def simple_circular(genome_size: int, seed: int) -> Genome:
    return Genome([StyledSequence.circular(generate(genome_size, seed))])


def simple_diploid() -> Genome:
    hap1 = bytearray(generate(100, 0))
    hap2 = bytearray(hap1)
    hap2[30] = ord("C")
    hap2[80] = ord("T")
    return Genome([StyledSequence.linear(bytes(hap1)), StyledSequence.linear(bytes(hap2))])


def diploid(hap_size: int, hap_seed: int, div_rate: float, div_seed: int) -> Genome:
    hap_a = generate(hap_size, hap_seed)
    hap_b, _ops = random_mutation(hap_a, MutationProfile.uniform(div_rate), div_seed)
    return Genome([StyledSequence.linear(hap_a), StyledSequence.linear(hap_b)])


def tandem_repeat_haploid(
    unit_size: int, n_unit: int, divergence_init: float, unit_seed: int, hap_seed: int
) -> Genome:
    return tandem_repeat_haploid_with_unique_ends(
        unit_size, n_unit, divergence_init, unit_seed, hap_seed, 0
    )


def tandem_repeat_haploid_with_unique_ends(
    unit_size: int,
    n_unit: int,
    divergence_init: float,
    unit_seed: int,
    hap_seed: int,
    end_length: int,
) -> Genome:
    unit = generate(unit_size, unit_seed)
    rep = tandem_repeat(unit, n_unit)
    hap_a, _ = random_mutation(rep, MutationProfile.uniform(divergence_init), hap_seed)
    prefix = generate(end_length, (unit_seed + 1) & 0xFFFFFFFFFFFFFFFF)
    suffix = generate(end_length, (unit_seed - 1) & 0xFFFFFFFFFFFFFFFF)
    return Genome([StyledSequence.linear(join(prefix, join(hap_a, suffix)))])


def tandem_repeat_diploid(
    unit_size: int,
    n_unit: int,
    divergence_init: float,
    unit_seed: int,
    hap_seed: int,
    divergence_between_haplotypes: float,
    div_seed: int,
) -> Genome:
    hap = tandem_repeat_haploid(unit_size, n_unit, divergence_init, unit_seed, hap_seed)
    hap_a = hap[0]
    hap_b_seq, _ops = random_mutation(
        hap_a.seq, MutationProfile.uniform(divergence_between_haplotypes), div_seed
    )
    return Genome([hap_a, StyledSequence.linear(hap_b_seq)])


def tandem_repeat_polyploid_with_unique_ends(
    unit_size: int,
    n_unit: int,
    divergence_init: float,
    unit_seed: int,
    hap_seed: int,
    end_length: int,
    n_haplotypes: int,
    divergence_between_haplotypes: float,
    div_seed: int,
) -> Genome:
    hap = tandem_repeat_haploid_with_unique_ends(
        unit_size, n_unit, divergence_init, unit_seed, hap_seed, end_length
    )
    seqs = [hap[0]]
    rng = np.random.Generator(np.random.PCG64(div_seed))
    for _ in range(1, n_haplotypes):
        hap_b_seq, _ops = random_mutation_with_rng(
            hap[0].seq, MutationProfile.uniform(divergence_between_haplotypes), rng
        )
        seqs.append(StyledSequence.linear(hap_b_seq))
    return Genome(seqs)


def tandem_repeat_polyploid_with_unique_homo_ends(
    unit_size: int,
    n_unit: int,
    unit_seed: int,
    divergence_init: float,
    div_init_seed: int,
    end_length: int,
    n_haplotypes: int,
    divergence_between_haplotypes: float,
    div_seed: int,
) -> Genome:
    """Tandem-repeat polyploid genome whose prefix/suffix are shared
    (homozygous) across haplotypes (ref: genome.rs:294)."""
    unit = generate(unit_size, unit_seed)
    rep = tandem_repeat(unit, n_unit)
    rep, _ops = random_mutation(rep, MutationProfile.uniform(divergence_init), div_init_seed)
    prefix = generate(end_length, (unit_seed + 1) & 0xFFFFFFFFFFFFFFFF)
    suffix = generate(end_length, (unit_seed - 1) & 0xFFFFFFFFFFFFFFFF)

    seqs = [StyledSequence.linear(join(prefix, join(rep, suffix)))]
    rng = np.random.Generator(np.random.PCG64(div_seed))
    for _ in range(1, n_haplotypes):
        rep_mut, _ops = random_mutation_with_rng(
            rep, MutationProfile.uniform(divergence_between_haplotypes), rng
        )
        seqs.append(StyledSequence.linear(join(prefix, join(rep_mut, suffix))))
    return Genome(seqs)


def tandem_repeat_500bp() -> Genome:
    seed = 1
    return tandem_repeat_polyploid_with_unique_ends(10, 50, 0.0, seed, seed, 50, 2, 0.01, seed)


def u500(n: int) -> Genome:
    """500bp unit n-times repeat, 300bp unique ends, diploid (ref: genome.rs u500)."""
    return tandem_repeat_polyploid_with_unique_homo_ends(500, n, 0, 0.02, 1, 300, 2, 0.02, 0)


def u20(n: int) -> Genome:
    """20bp unit n-times repeat, 300bp unique ends, diploid (ref: genome.rs u20)."""
    return tandem_repeat_polyploid_with_unique_homo_ends(20, n, 0, 0.02, 1, 300, 2, 0.02, 0)
