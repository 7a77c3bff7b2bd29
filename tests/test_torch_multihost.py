"""The port's multi-process scale-out over two gloo ranks, the counterpart
of tests/test_multihost.py.

Each rank is a CPU subprocess that joins the group through
``parallel.multihost.initialize`` on a free local port: a read-sharded
total over a mesh that spans both ranks; the scorer, the batch scoring and
the decode with both ranks holding shards that score (reads, then
candidates, across ranks); and the CLI's ``sample`` under ``--dist`` with
``--mesh 1x8``, against a single process and the JAX package."""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu import cli as jax_cli
from dbgphmm_tpu.ops import forward as JF
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.phmm.model import linear_random_phmm as jax_linear_random_phmm
from dbgphmm_tpu_torch import cli
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import output as out
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops.batch import candidate_log_likelihoods
from dbgphmm_tpu_torch.ops.forward import forward_scores, pad_reads, to_device
from dbgphmm_tpu_torch.phmm.model import linear_random_phmm
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.seq.collection import StyledSequence
from dbgphmm_tpu_torch.seq.random_seq import generate

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180  # seconds, per rank

_WORKER = textwrap.dedent("""
    import sys
    port, pid = sys.argv[1], int(sys.argv[2])

    from dbgphmm_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", 2, pid)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from dbgphmm_tpu_torch.ops.forward import pad_reads, to_device
    from dbgphmm_tpu_torch.parallel import make_mesh
    from dbgphmm_tpu_torch.phmm.model import linear_random_phmm
    from dbgphmm_tpu_torch.phmm.params import PHMMParams
    from dbgphmm_tpu_torch.seq.random_seq import generate

    # identical deterministic inputs on every rank
    dm = to_device(linear_random_phmm(120, 3, PHMMParams.default()), "cpu",
                   torch.float64)
    seq = generate(120, 3)
    reads = [seq[i : i + 60] for i in range(0, 55, 5)]  # 11 reads
    codes, lens = pad_reads(reads)

    # 8 shards over the two ranks, four each; one CPU per rank globally
    mesh = make_mesh(8, device="cpu")
    assert mesh.is_global and mesh.size == 8, mesh
    assert mesh.ranks.ravel().tolist() == [0] * 4 + [1] * 4, mesh.ranks
    assert multihost.global_mesh(device="cpu").size == 2

    # per-rank read loading: keep only this rank's slice, pad the rest
    n_pad = -(-codes.shape[0] // 8) * 8
    codes_g = np.full((n_pad, codes.shape[1]), -1, dtype=codes.dtype)
    lens_g = np.zeros((n_pad,), dtype=lens.dtype)
    sl = multihost.process_read_slice(codes.shape[0], mesh)
    codes_g[sl] = np.pad(codes, ((0, n_pad - len(codes)), (0, 0)),
                         constant_values=-1)[sl]
    lens_g[sl] = np.pad(lens, (0, n_pad - len(lens)))[sl]

    total = multihost.distributed_forward_total(dm, codes_g, lens_g, mesh)
    print(f"OK pid={pid} total={total!r}", flush=True)
""")


# the scorer case every rank and the single process build alike: the toy of
# tests/test_multihost.py with 70 reads, so that under a 1x8 mesh (blocks
# of 16 reads) rank 1 holds the fifth block, and its mapping from a local
# decode
_CASE = textwrap.dedent("""
    def case():
        import numpy as np

        from dbgphmm_tpu_torch.multi_dbg import MultiDbg
        from dbgphmm_tpu_torch.multi_dbg.posterior import generate_mappings
        from dbgphmm_tpu_torch.ops.forward import pad_reads
        from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions
        from dbgphmm_tpu_torch.phmm.params import PHMMParams
        from dbgphmm_tpu_torch.phmm.template import make_template
        from dbgphmm_tpu_torch.seq.collection import ReadCollection, StyledSequence

        h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGTAGGATCC"
        h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGTAGGATCC"
        dbg = MultiDbg.from_styled_seqs(
            8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
        rng = np.random.default_rng(7)
        reads = ReadCollection([
            (h1, h2)[int(rng.integers(2))][int(rng.integers(0, 8)):
                                           int(rng.integers(28, 37))]
            for _ in range(70)])
        params = PHMMParams.uniform(0.001)
        maps = generate_mappings(dbg, params, reads, "cpu")
        codes, lens = pad_reads(list(reads))
        tpl = make_template(dbg, params)
        width = max(a.shape[1] for a in maps.nodes)
        pos = precompute_positions(pad_mappings(maps, codes.shape[1], width),
                                   tpl.parent_idx,
                                   parent_exists=tpl.parent_exists)
        base = dbg.get_copy_nums()
        # the draft, +1 on each compact edge, and all zeros (every read -inf)
        cands = ([list(base)]
                 + [[c + (j == e) for j, c in enumerate(base)]
                    for e in range(len(base))] + [[0] * len(base)])
        return dict(dbg=dbg, reads=reads, params=params, maps=maps,
                    codes=codes, lens=lens, tpl=tpl, pos=pos, cands=cands)
""")

_SCORE_WORKER = textwrap.dedent("""
    import sys
    port, pid, shape, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]

    from dbgphmm_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", 2, pid)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from dbgphmm_tpu_torch.multi_dbg.posterior import generate_mappings
    from dbgphmm_tpu_torch.ops import mapped_scorer as T
    from dbgphmm_tpu_torch.ops.batch import candidate_log_likelihoods
    from dbgphmm_tpu_torch.parallel import make_mesh
""") + _CASE + textwrap.dedent("""
    S = case()
    n_cs, n_rs = map(int, shape.split("x"))
    mesh = make_mesh(n_cs * n_rs, cand_axis=n_cs, device="cpu")
    assert mesh.is_global and sorted(set(mesh.ranks.ravel())) == [0, 1], mesh.ranks
    maps = generate_mappings(S["dbg"], S["params"], S["reads"], "cpu", mesh=mesh)
    scorer = T.MappedScorer(S["tpl"], S["pos"], S["codes"], S["lens"],
                            S["params"], "cpu", mesh=mesh)
    n0 = T.mapped_scores_log_reference.calls
    per_read = scorer.per_read(S["cands"])
    launches = T.mapped_scores_log_reference.calls - n0
    models = [S["tpl"].model_for(cn) for cn in S["cands"]]
    dense = candidate_log_likelihoods(models, S["codes"], S["lens"], "cpu",
                                      mesh=mesh)
    mapped = candidate_log_likelihoods(models, S["codes"], S["lens"], "cpu",
                                       positions=S["pos"], mesh=mesh)
    np.savez(f"{out}/rank{pid}.npz", per_read=per_read, launches=launches,
             dense=dense, mapped=mapped, read_logps=maps.read_logps,
             **{f"nodes{r}": a for r, a in enumerate(maps.nodes)})
    print(f"OK pid={pid} launches={launches}", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    # a rank whose peer failed stops waiting well inside TIMEOUT
    env = {**os.environ, "PYTHONPATH": str(REPO), "DBGPHMM_DIST_TIMEOUT_S": "120"}
    env.pop("JAX_PLATFORMS", None)
    return env


def _run_ranks(argvs):
    """Start one subprocess per argv, wait for all; each must exit 0."""
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{o}"
    return outs


def test_two_process_cpu_mesh_read_sharding():
    """distributed_forward_total over two ranks, each holding only its
    slice of the reads: both ranks return the same total, equal to the
    single-process total and to the JAX oracle within 1e-6."""
    port = _free_port()
    outs = _run_ranks([[sys.executable, "-c", _WORKER, str(port), str(i)]
                       for i in range(2)])
    totals = []
    for i, o in enumerate(outs):
        m = re.search(rf"OK pid={i} total=(\S+)", o)
        assert m, o
        totals.append(float(m.group(1)))
    assert totals[0] == totals[1]

    seq = generate(120, 3)
    reads = [seq[i:i + 60] for i in range(0, 55, 5)]
    codes, lens = pad_reads(reads)
    dm = to_device(linear_random_phmm(120, 3, PHMMParams.default()), "cpu",
                   torch.float64)
    single = float(forward_scores(dm, torch.as_tensor(codes),
                                  torch.as_tensor(lens)).sum())
    dm_j = JF.to_device(jax_linear_random_phmm(
        120, 3, jax_params.PHMMParams.default()), dtype=jnp.float64)
    oracle = float(np.sum(np.asarray(JF.forward_scores(
        dm_j, jnp.asarray(codes), jnp.asarray(lens), renorm=True))))
    assert abs(totals[0] - single) < 1e-6, (totals, single)
    assert abs(totals[0] - oracle) < 1e-6, (totals, oracle)


@pytest.mark.parametrize("shape,rank_launches", [
    ("1x8", [4, 1]),  # reads across ranks: 70 reads, blocks of 16, 4 + 1
    ("2x4", [3, 3]),  # candidates across ranks: a row of shards per rank
])
def test_two_process_scorer_across_ranks(tmp_path, shape, rank_launches):
    """MappedScorer (K1's twin), candidate_log_likelihoods (dense and
    mapped) and generate_mappings over a mesh that spans two ranks, each
    of which scores: every rank launches its own shards only (together
    one launch per block with reads and candidate row), ends with the
    same arrays as the other, and equals one process without a mesh
    (float64: per read within 1e-9, the same -inf pattern; totals within
    1e-9; the same mapping nodes)."""
    port = _free_port()
    outs = _run_ranks([[sys.executable, "-c", _SCORE_WORKER, str(port),
                        str(i), shape, str(tmp_path)] for i in range(2)])
    for i, o in enumerate(outs):
        assert f"OK pid={i}" in o, o
    got = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    assert [int(g["launches"]) for g in got] == rank_launches
    for key in ("per_read", "dense", "mapped", "read_logps"):
        np.testing.assert_array_equal(got[0][key], got[1][key])

    ns = {}
    exec(_CASE, ns)
    S = ns["case"]()
    local = T.MappedScorer(S["tpl"], S["pos"], S["codes"], S["lens"],
                           S["params"], "cpu").per_read(S["cands"])
    fin = np.isfinite(local)
    assert fin[:-1].all() and not fin[-1].any()
    np.testing.assert_array_equal(np.isfinite(got[0]["per_read"]), fin)
    np.testing.assert_allclose(got[0]["per_read"][fin], local[fin], rtol=0,
                               atol=1e-9)
    models = [S["tpl"].model_for(cn) for cn in S["cands"]]
    for key, kw in (("dense", {}), ("mapped", dict(positions=S["pos"]))):
        want = candidate_log_likelihoods(models, S["codes"], S["lens"], "cpu",
                                         **kw)
        np.testing.assert_allclose(got[0][key], want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[0]["read_logps"], S["maps"].read_logps,
                               rtol=0, atol=1e-9)
    for r, want in enumerate(S["maps"].nodes):
        a = got[0][f"nodes{r}"]
        w = min(a.shape[1], want.shape[1])
        np.testing.assert_array_equal(a[:, :w], want[:, :w])
        assert (a[:, w:] < 0).all() and (want[:, w:] < 0).all()


def _strip_times(text):
    return re.sub(r'"time_[a-z]+":[0-9.e-]+', '"t":0', text)


def _numbers_close(got, ref, rel=1e-9):
    """The same text, numbers with a fraction or exponent to ``rel`` (the
    packages round the last digits of a likelihood differently)."""
    gt, rt = re.split(r"([\t\n,: \[\]{}])", got), re.split(r"([\t\n,: \[\]{}])", ref)
    assert len(gt) == len(rt)
    for a, b in zip(gt, rt):
        if a != b:
            assert re.fullmatch(r"-?[0-9.]+(e-?[0-9]+)?", a), (a, b)
            assert float(a) == pytest.approx(float(b), rel=rel, abs=1e-12), (a, b)


def test_two_process_cli_sample_matches_single(tmp_path, capsys):
    """The CLI's ``sample`` (mappings, posterior sampling, scoring) under
    ``--dist`` in two ranks with ``--mesh 1x8`` writes, on each rank, the
    .post file of a single-process port run (times stripped), and that of
    the JAX CLI's single run, numbers to 1e-9 relative.  The graph is
    tests/test_multihost.py's toy, started one +-1 cycle off the truth so
    that the climb scores more than one sample."""
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGTAGGATCC"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGTAGGATCC"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    assert dbg.get_copy_nums() == [2, 1, 1, 2]
    dbg.set_copy_nums([2, 2, 0, 2])
    out.to_dbg_file(dbg, tmp_path / "toy.dbg")
    reads = [h1[2:30], h2[3:33], h1[:28], h2[4:], h1[5:34], h2[:30]]
    with open(tmp_path / "reads.fa", "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.decode()}\n")
    common = ["-d", str(tmp_path / "toy.dbg"), "-G", str(len(h1)), "-I", "5",
              str(tmp_path / "reads.fa")]

    port = _free_port()
    _run_ranks([[sys.executable, "-m", "dbgphmm_tpu_torch",
                 f"--dist=localhost:{port},2,{i}", "--mesh", "1x8", "sample",
                 "--device", "cpu", *common, "-o", str(tmp_path / f"multi{i}")]
                for i in range(2)])
    cli.main(["sample", "--device", "cpu", *common, "-o",
              str(tmp_path / "single")])
    jax_cli.main(["--cpu", "sample", *common, "-o", str(tmp_path / "jax")])
    capsys.readouterr()

    single = _strip_times((tmp_path / "single.post").read_text())
    assert single.count("\nC\t") == 2 and "[2,1,1,2]" in single
    for i in range(2):
        assert _strip_times((tmp_path / f"multi{i}.post").read_text()) == single
    _numbers_close(single, _strip_times((tmp_path / "jax.post").read_text()))
