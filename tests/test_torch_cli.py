"""The port's command line (python -m dbgphmm_tpu_torch)."""

import argparse
import json
import re
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

from test_torch_posterior import one_torch_thread  # noqa: F401

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


HOST_ONLY = ("euler", "raw-dbg", "draft", "sim-draft", "edit-dist", "modify-dbg")


@pytest.mark.parametrize("command", [
    None, "infer", "sim-infer", "euler", "inspect", "sample",
    "sample-from-true", "raw-dbg", "draft", "sim-draft", "mapping", "freq",
    "table", "edit-dist", "modify-dbg", "extend-mapping", "speed-test"])
def test_cli_takes_the_jax_cli_flags(command):
    """Every flag of the JAX CLI's subcommand is accepted; --device is the
    one addition, on every command that runs the PHMM.  At the top level
    (``None``) the JAX CLI's --mesh and --dist, with the same defaults; its
    --cpu is each command's ``--device cpu`` here."""
    of = ((lambda parser: parser) if command is None
          else (lambda parser: _subparser(parser, command)))
    ours = _options(of(cli.build_parser()))
    ref = _options(of(jax_cli.build_parser()))
    if command is None:
        assert {"--mesh", "--dist"} <= ref
        ref = ref - {"--cpu"}
    assert ref <= ours
    extra = set() if command in HOST_ONLY + (None,) else {"--device"}
    assert ours - ref == extra
    defaults = lambda parser: {a.dest: a.default for a in of(parser)._actions}
    ref_d = defaults(jax_cli.build_parser())
    ref_d.pop("cpu", None)
    assert {k: v for k, v in defaults(cli.build_parser()).items()
            if k in ref_d} == ref_d


def test_cli_mesh_refuses_what_the_devices_cannot_hold(tmp_path):
    """--mesh is taken by infer, sim-infer and sample only; a mesh of more
    CUDA devices than are visible exits non-zero with a message (it is
    never shrunk nor moved to the CPU)."""
    with pytest.raises(SystemExit, match="--mesh is taken by infer"):
        cli.main(["--mesh", "2", "table", "-d", "unused.dbg", "reads.fa",
                  "--device", "cpu"])
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"--mesh {n}: a mesh of {n} CUDA"):
        cli._make_mesh_from_arg(str(n), torch.device("cuda"))
    mesh = cli._make_mesh_from_arg("2x3", torch.device("cpu"))
    assert mesh.shape == {"cand": 2, "reads": 3}
    assert cli._make_mesh_from_arg("4", torch.device("cpu")).shape == {
        "cand": 1, "reads": 4}
    assert cli._make_mesh_from_arg(None, torch.device("cpu")) is None
    with pytest.raises(SystemExit, match="--mesh 2x: "):
        cli._make_mesh_from_arg("2x", torch.device("cpu"))


@pytest.mark.parametrize("command", [
    ["infer", "-d", "data/bench/data.dbg", "-o", "unused", "-K", "41",
     "-G", "1000", "reads.fa"],
    ["sim-infer", "data/bench/data.json", "-d", "data/bench/data.dbg",
     "-o", "unused", "-K", "41"],
    ["inspect", "-d", "data/bench/data.dbg", "data/bench/data.json"],
    ["sample", "-d", "data/bench/data.dbg", "-o", "unused", "-G", "1000",
     "reads.fa"],
    ["sample-from-true", "data/bench/data.json", "-k", "40", "-o", "unused"],
    ["table", "-d", "data/bench/data.dbg", "reads.fa"],
    ["speed-test"],
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


# -- the remaining commands write the JAX CLI's files (tests/test_cli.py) -----


@pytest.fixture(scope="module")
def simdir(tmp_path_factory):
    """test_cli.py's tiny dataset, written by both CLIs' sim-draft (port:
    prefix t, JAX: prefix j)."""
    d = tmp_path_factory.mktemp("sim")
    argv = ["sim-draft", "-k", "12", "--unit-size", "10", "--n-unit", "4",
            "--end-length", "30", "--div-hap", "0.05", "-C", "12", "-L", "200",
            "-p", "0.001", "-o"]
    cli.main(argv + [str(d / "t")])
    jax_cli.main(["--cpu"] + argv + [str(d / "j")])
    return d


def _same_files(d, *names):
    """Port (prefix t) and JAX (prefix j) files byte for byte."""
    for name in names:
        t, j = (d / name.format(p=p) for p in ("t", "j"))
        assert t.read_bytes() == j.read_bytes(), name


def _same_text(d, *names):
    """The same text, but numbers with a fraction or exponent to 1e-9
    relative (the .map files print log-probabilities in full, and the two
    packages round their last digits differently)."""
    for name in names:
        t, j = ((d / name.format(p=p)).read_text() for p in ("t", "j"))
        tt, jt = re.split(r"([\t\n,: ])", t), re.split(r"([\t\n,: ])", j)
        assert len(tt) == len(jt), name
        for a, b in zip(tt, jt):
            if a != b:
                assert re.fullmatch(r"-?[0-9.]+e?-?[0-9]*", a), (name, a, b)
                assert float(a) == pytest.approx(float(b), rel=1e-9, abs=1e-12), \
                    (name, a, b)


def test_sim_draft_writes_the_jax_files(simdir):
    _same_files(simdir, *(f"{{p}}{ext}" for ext in (
        ".json", ".genome.fa", ".reads.fa", ".reads.sam", ".dbg", ".paths")))


def test_raw_dbg_and_draft_write_the_jax_files(simdir, capsys):
    d = simdir
    for main, p, pre in ((cli.main, "t", []), (jax_cli.main, "j", ["--cpu"])):
        main(pre + ["raw-dbg", "-k", "12", "-M", "2", str(d / f"{p}.reads.fa"),
                    "-g", str(d / f"{p}.raw.gfa")])
        main(pre + ["draft", "-k", "12", "-M", "2", "-G", "180",
                    str(d / f"{p}.reads.fa"), "-d", str(d / f"{p}.draft.dbg"),
                    "-g", str(d / f"{p}.draft.gfa")])
    assert (d / "t.raw.gfa").read_text().startswith("S\t")
    _same_files(d, "{p}.raw.gfa", "{p}.draft.dbg", "{p}.draft.gfa")


def _outputs(capsys, prefix):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(prefix)]


def test_table_matches_jax(simdir, capsys):
    """table --device cpu (float64 dense forward): each read's logP as the
    JAX command prints it, and the total."""
    d = simdir
    scores = cli.main(["table", "-d", str(d / "t.dbg"), str(d / "t.reads.fa"),
                       "--device", "cpu"])
    got = _outputs(capsys, ("read ", "# total"))
    jax_cli.main(["--cpu", "table", "-d", str(d / "j.dbg"), str(d / "j.reads.fa")])
    ref = _outputs(capsys, ("read ", "# total"))
    assert scores.dtype == torch.float64 and torch.isfinite(scores).all()
    assert got == ref and got[-1].startswith("# total logP")


def test_mapping_freq_and_edit_dist_match_jax(simdir, capsys):
    """mapping, freq (dense decode on the k=12 draft) and edit-dist write
    and print what the JAX commands do."""
    d = simdir
    for main, p, pre, dev in ((cli.main, "t", [], ["--device", "cpu"]),
                              (jax_cli.main, "j", ["--cpu"], [])):
        main(pre + ["mapping", "-d", str(d / f"{p}.dbg"), str(d / f"{p}.reads.fa"),
                    "-o", str(d / f"{p}.map")] + dev)
        main(pre + ["freq", "-d", str(d / f"{p}.dbg"), str(d / f"{p}.reads.fa"),
                    "-o", str(d / f"{p}.freq")] + dev)
    _same_text(d, "{p}.map")
    _same_files(d, "{p}.freq")
    capsys.readouterr()
    for main, pre in ((cli.main, []), (jax_cli.main, ["--cpu"])):
        main(pre + ["edit-dist", str(d / "t.genome.fa"), str(d / "t.reads.fa")])
    lines = _outputs(capsys, "pair ")
    half = len(lines) // 2
    assert half > 1 and lines[:half] == lines[half:]
    assert all("edit_dist=" in ln for ln in lines)


def test_modify_dbg_writes_the_jax_file(simdir):
    """modify-dbg applies an INSPECT sample's copy numbers as the JAX
    command does."""
    from dbgphmm_tpu_torch.multi_dbg import posterior as TP

    d = simdir
    dbg = TO.from_dbg_file(d / "t.dbg")
    post = TP.Posterior()
    for i, (cn, _info) in enumerate(to_short_neighbors(dbg, 8, 2)[:3]):
        post.add(TP.PosteriorSample(list(cn), TP.Score(-10.0 - i, 0.0, 100, 0.0)))
    TO.to_inspect_file(dbg, d / "x.inspect", post)
    for main, p, pre in ((cli.main, "t", []), (jax_cli.main, "j", ["--cpu"])):
        main(pre + ["modify-dbg", "-d", str(d / "t.dbg"), "--inspect",
                    str(d / "x.inspect"), "--sample-id", "1", "-o",
                    str(d / f"{p}.mod.dbg")])
    _same_files(d, "{p}.mod.dbg")
    assert TO.from_dbg_file(d / "t.mod.dbg").get_copy_nums() != dbg.get_copy_nums()


def test_extend_mapping_matches_jax(simdir, capsys):
    """extend-mapping -K 14 --device cpu: the same per-k .map and .dbg files
    and the same p_extend / p_true as the JAX command."""
    d = simdir
    for main, p, pre, dev in ((cli.main, "t", [], ["--device", "cpu"]),
                              (jax_cli.main, "j", ["--cpu"], [])):
        main(pre + ["extend-mapping", str(d / f"{p}.json"), "-d",
                    str(d / f"{p}.dbg"), "-K", "14", "-p", "0.001", "-o",
                    str(d / f"{p}.em")] + dev)
    lines = _outputs(capsys, "k=")
    fields = [dict(f.split("=") for f in ln.split()) for ln in lines]
    assert len(fields) == 4  # k = 13, 14 in each package
    for got, ref in zip(fields[:2], fields[2:]):
        assert got["k"] == ref["k"]
        for key in ("p_extend", "p_true"):
            assert float(got[key]) <= 0.0
            assert float(got[key]) == pytest.approx(float(ref[key]), abs=1e-3)
    for k in (13, 14):
        _same_text(d, f"{{p}}.em.k{k}.extend.map", f"{{p}}.em.k{k}.true.map")
        _same_files(d, f"{{p}}.em.k{k}.dbg", f"{{p}}.em.k{k}.gfa")
