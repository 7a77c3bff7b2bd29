"""The port's command line (python -m dbgphmm_tpu_torch)."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dbgphmm_tpu import cli as jax_cli
from dbgphmm_tpu_torch import cli
from dbgphmm_tpu_torch.e2e import Dataset
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import output as TO
from dbgphmm_tpu_torch.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu_torch.seq.genome import Genome
from dbgphmm_tpu_torch.seq.random_seq import generate

REPO = Path(__file__).resolve().parent.parent


def _run(*argv, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "dbgphmm_tpu_torch", *argv],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _subparser(parser, name):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices[name]


def _options(sub):
    return {s for a in sub._actions for s in a.option_strings} | {
        a.dest for a in sub._actions if not a.option_strings}


@pytest.mark.parametrize("command", ["infer", "sim-infer", "euler", "inspect",
                                     "sample", "sample-from-true"])
def test_cli_takes_the_jax_cli_flags(command):
    """Every flag of the JAX CLI's subcommand is accepted; --device is the
    one addition (every command but euler)."""
    ours = _options(_subparser(cli.build_parser(), command))
    ref = _options(_subparser(jax_cli.build_parser(), command))
    assert ref <= ours
    extra = {"--device"} if command != "euler" else set()
    assert ours - ref == extra


@pytest.mark.parametrize("command", [
    ["infer", "-d", "data/bench/data.dbg", "-o", "unused", "-K", "41",
     "-G", "1000", "reads.fa"],
    ["sim-infer", "data/bench/data.json", "-d", "data/bench/data.dbg",
     "-o", "unused", "-K", "41"],
    ["inspect", "-d", "data/bench/data.dbg", "data/bench/data.json"],
    ["sample", "-d", "data/bench/data.dbg", "-o", "unused", "-G", "1000",
     "reads.fa"],
    ["sample-from-true", "data/bench/data.json", "-k", "40", "-o", "unused"],
])
def test_cli_refuses_cuda_without_a_gpu(command):
    """Without --device cpu the CLI asks for CUDA; on a machine without a
    GPU it exits non-zero with a clear message and runs nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present here")
    res = _run(*command)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "--device cpu" in res.stderr
    assert "# started_at" in res.stdout and "[seed]" not in res.stdout


def test_cli_euler_matches_jax(tmp_path):
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(b"TTAGGCTTCGATCGAATGCCAGGTTACG")])
    TO.to_dbg_file(dbg, tmp_path / "g.dbg")
    res = _run("euler", "-d", str(tmp_path / "g.dbg"), str(tmp_path / "ours.fa"))
    assert res.returncode == 0, res.stderr
    jax_cli.main(["euler", "-d", str(tmp_path / "g.dbg"),
                  str(tmp_path / "ref.fa")])
    assert (tmp_path / "ours.fa").read_text() == (tmp_path / "ref.fa").read_text()


@pytest.fixture(scope="module")
def seeded_case(tmp_path_factory):
    """A diploid in the seeded regime (more than 32,768 full edges at k=40):
    two random 16.5 kb stretches that merge into one 800-base stretch whose
    copies differ by 4 SNPs, so the graph has 4 bubbles.  Four exact reads
    of 350-400 bases cover the shared stretch of both haplotypes.  The draft
    is the true graph with one bubble's copy numbers moved to [2, 0]: a
    +-1 cycle off the truth, so the orig and true scores differ.  The case
    is built with the port's objects and written by the port's writers;
    the JAX CLI, the reference, reads the same files."""
    d = tmp_path_factory.mktemp("seeded_case")
    s = bytearray(generate(800, 13))
    s2 = bytearray(s)
    for p in range(100, 800, 200):
        s2[p] = ord({"A": "C", "C": "G", "G": "T", "T": "A"}[chr(s2[p])])
    h1 = generate(16500, 11) + bytes(s)
    h2 = generate(16500, 12) + bytes(s2)
    genome = Genome([StyledSequence.linear(h1), StyledSequence.linear(h2)])
    reads = ReadCollection([bytes(s[:400]), bytes(s[400:]), bytes(s2[20:370]),
                            bytes(s2[420:])])
    dbg = MultiDbg.from_styled_seqs(40, list(genome))
    assert dbg.n_edges_full() > 32768
    true = dbg.get_copy_nums()
    sizes = [len(dbg.edges_in_full(e)) for e in range(dbg.n_edges_compact())]
    flip = next(cn for cn, _i in to_short_neighbors(dbg, 8, 2)
                if all(sizes[e] <= 41 for e in range(len(cn)) if cn[e] != true[e]))
    dbg.set_copy_nums(flip)
    Dataset(genome, reads, PHMMParams.uniform(0.001)).to_json_file(d / "data.json")
    TO.to_dbg_file(dbg, d / "draft.dbg")
    reads.to_fasta(d / "reads.fa")
    return d, genome.genome_size()


def _scored_lines(stdout):
    """{name: (score json, copy numbers)} of inspect's orig / true lines."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split("\t")
        if parts[0] in ("orig", "true") and len(parts) == 5:
            out[parts[0]] = (json.loads(parts[3]), json.loads(parts[4]))
    return out


def test_cli_inspect_matches_jax(seeded_case, capsys):
    """inspect --device cpu (seeded mapping, K2's float64 twin) against the
    JAX inspect --cpu: the orig and true likelihoods and posteriors agree to
    1e-6, the copy numbers and the rest of the score are equal."""
    d, _size = seeded_case
    jax_cli.main(["--cpu", "inspect", "-d", str(d / "draft.dbg"),
                  str(d / "data.json"), "-o", str(d / "jax")])
    ref = _scored_lines(capsys.readouterr().out)
    scores = cli.main(["inspect", "-d", str(d / "draft.dbg"),
                       str(d / "data.json"), "-o", str(d / "torch"),
                       "--device", "cpu"])
    got = _scored_lines(capsys.readouterr().out)
    assert set(got) == set(ref) == {"orig", "true"}
    for name in ("orig", "true"):
        (g, g_cn), (r, r_cn) = got[name], ref[name]
        assert g_cn == r_cn
        for key in ("prior", "genome_size", "n_euler_circuits"):
            assert g[key] == pytest.approx(r[key], rel=1e-12), key
        assert abs(g["likelihood"] - r["likelihood"]) <= 1e-6
    assert [s.likelihood for s in scores] == [got["orig"][0]["likelihood"],
                                              got["true"][0]["likelihood"]]
    assert got["true"][0]["likelihood"] > got["orig"][0]["likelihood"] + 1.0
    n_lines = [len((d / f"{p}.true.map").read_text().splitlines())
               for p in ("jax", "torch")]
    assert n_lines[0] == n_lines[1] > 0


def test_cli_sample_matches_jax(seeded_case, capsys):
    """sample --device cpu -I 1 against the JAX sample --cpu -I 1: the same
    samples in the .post files, the same best copy numbers, likelihoods to
    1e-6."""
    d, size = seeded_case
    common = ["-d", str(d / "draft.dbg"), "-G", str(size), "-I", "1",
              str(d / "reads.fa")]
    jax_cli.main(["--cpu", "sample", "-o", str(d / "jax"), *common])
    cli.main(["sample", "-o", str(d / "torch"), "--device", "cpu", *common])
    capsys.readouterr()
    ref = TO.from_post_file(d / "jax.post")
    got = TO.from_post_file(d / "torch.post")
    assert got.max_copy_nums() == ref.max_copy_nums()
    assert got.max_copy_nums() != TO.from_dbg_file(
        d / "draft.dbg").get_copy_nums()  # the climb moved
    assert {tuple(s.copy_nums) for s in got.samples} == {
        tuple(s.copy_nums) for s in ref.samples}
    for s in got.samples:
        r = ref.find(s.copy_nums).score
        np.testing.assert_allclose(s.score.likelihood, r.likelihood, rtol=0,
                                   atol=1e-6)
    assert (d / "torch.inspect").exists()


def test_cli_sample_from_true_matches_jax(seeded_case, capsys):
    """sample-from-true --device cpu -I 1 against the JAX command: the true
    k=40 graph of the seeded case is the argmax in both, with the same
    samples and likelihoods to 1e-6."""
    d, _size = seeded_case
    common = [str(d / "data.json"), "-k", "40", "-I", "1"]
    jax_cli.main(["--cpu", "sample-from-true", *common, "-o", str(d / "jsft")])
    post = cli.main(["sample-from-true", *common, "-o", str(d / "tsft"),
                     "--device", "cpu"])
    assert capsys.readouterr().out.count("# truth is argmax: True") == 2
    ref = TO.from_post_file(d / "jsft.post")
    got = TO.from_post_file(d / "tsft.post")
    assert got.max_copy_nums() == ref.max_copy_nums() == post.max_copy_nums()
    assert {tuple(s.copy_nums) for s in got.samples} == {
        tuple(s.copy_nums) for s in ref.samples}
    for s in got.samples:
        np.testing.assert_allclose(s.score.likelihood,
                                   ref.find(s.copy_nums).score.likelihood,
                                   rtol=0, atol=1e-6)
    assert (d / "tsft.inspect").exists()
