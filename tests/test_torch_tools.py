"""The port's tools (dbgphmm_tpu_torch/scripts/) against the JAX package's
(scripts/) on the same files, at toy size on the CPU.

A seeded toy run writes the files: the port's CLI ``sim-infer`` on a
tandem-repeat draft (k=16, ~300 full edges), in this process, with
DENSE_COMPUTE_MAX_NODES set to 0 in both packages (monkeypatch, as
tests/test_torch_posterior.py does) so that its mappings are seeded and
refined as at production scale.  Each tool then runs as ``python <tool>
<args>`` would, in this process (``runpy``, ``sys.argv`` set, standard
output captured), the JAX tool on JAX_PLATFORMS=cpu and the port's tool
with ``--device cpu`` where it takes one.  Tolerances: the parsed tables,
the diagnostic fractions, the counts and the pages exactly (the printed
text is equal); scores 1e-9 relative where both sides compute in float64
(the dense oracle of validate_large_n_mapping), and the kernel gate,
1e-5 |ref| + 0.05 nats, where one side is float32 (its frontier decode).
JAX's bench_real_graph runs its ``--xla`` path (the port has no XLA tier)
from a copy in a temporary directory, so that the bench_extra.json it
writes lands there.
"""

import contextlib
import io
import json
import os
import re
import runpy
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dbgphmm_tpu.multi_dbg.posterior as JP
import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
JS = REPO / "scripts"
PS = REPO / "dbgphmm_tpu_torch" / "scripts"
TOY = ["sim-draft", "-k", "16", "--unit-size", "30", "--n-unit", "5",
       "--end-length", "50", "-C", "8", "-L", "150", "-p", "0.001"]
INFER = ["-K", "17", "-S", "10", "-I", "1", "--device", "cpu"]
REL_TOL, ABS_TOL = 1e-5, 0.05  # the kernel gate, per read


def run_tool(path, *args):
    """Standard output of ``python path args`` run in this process (a
    SystemExit of the tool is returned as its code)."""
    buf, argv, spath = io.StringIO(), sys.argv, list(sys.path)
    sys.argv = [str(path), *map(str, args)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    except SystemExit as e:
        assert not e.code, f"{path.name} exited {e.code}: {buf.getvalue()}"
    finally:
        sys.argv, sys.path[:] = argv, spath
    return buf.getvalue()


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The seeded toy run: (directory, its log)."""
    d = tmp_path_factory.mktemp("tools")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
            mp.setattr(JP, "DENSE_COMPUTE_MAX_NODES", 0)
            mp.setattr(TP, "DENSE_COMPUTE_MAX_NODES", 0)
            cli.main([*TOY, "-o", str(d / "sim")])
            cli.main(["sim-infer", str(d / "sim.json"), "-d", str(d / "sim.dbg"),
                      "-o", str(d / "out"), *INFER])
    finally:
        torch.set_num_threads(n)
    (d / "out.log").write_text(buf.getvalue())
    assert (d / "out.k17.inspect").exists(), buf.getvalue()[-3000:]
    return d


def rows_of(text):
    """{k: {column: value}} of a perk_budget table."""
    out = {}
    for line in text.splitlines():
        if line.startswith("k="):
            k, *cols = line.split()
            out[int(k[2:])] = dict(c.split("=", 1) for c in cols)
    return out


def test_perk_budget_matches_jax_on_a_seeded_port_log(toy):
    """Both tools on the seeded run's log: the same stages and, in every
    column both have, the same values; setup_s (the port's positions and
    streams, where the JAX tool has positions_s / streams_s) that of the
    stage's `# stage` line to the printed digit."""
    log = toy / "out.log"
    port, ref = run_tool(PS / "perk_budget.py", log), run_tool(JS / "perk_budget.py", log)
    p, r = rows_of(port), rows_of(ref)
    assert sorted(p) == sorted(r) == [16, 17]
    for k in p:
        for c in ("sampling_s", "n_samples", "seed_s", "extend_s", "next_k"):
            assert p[k][c] == (r[k][c] or "-"), (k, c)
    stages = [json.loads(ln[8:]) for ln in log.read_text().splitlines()
              if ln.startswith("# stage {")]
    assert p[16]["setup_s"] == str(round(stages[0]["setup_s"], 1))
    assert p[16]["next_k"] == "17" and float(p[16]["seed_s"]) >= 0
    assert re.search(r"^# stages=2 restarts=0 ", port, re.M)
    assert re.search(r"^# stages=2 restarts=0 ", ref, re.M)
    md = run_tool(PS / "perk_budget.py", log, "--md").splitlines()
    assert md[0] == ("| k | sampling_s | n_samples | seed_s | setup_s | "
                     "extend_s | next_k |")


def test_perk_budget_reads_a_supervised_toy_run(tmp_path):
    """A toy ``sim.sh supervise`` run, killed once it has dumped a
    k-stage and restarted by the supervisor: the port's perk_budget
    counts the restart line and keeps the restarted stage's later values;
    the JAX tool (which knows only its own supervisor's line) agrees on
    every stage."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1", PYTHON=sys.executable)
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["sim-draft", "-k", "12", "--unit-size", "10", "--n-unit",
                  "4", "--end-length", "30", "-C", "12", "-L", "200", "-o",
                  str(tmp_path / "sim")])
    pre, log = tmp_path / "run" / "out", tmp_path / "run" / "out.log"
    sup = subprocess.Popen(
        ["bash", str(PS / "sim.sh"), "supervise", str(pre), "sim.dbg",
         "sim-infer", "sim.json", "-K", "13", "-S", "10", "-I", "2",
         "--device", "cpu"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        t0 = time.time()
        while not (tmp_path / "run" / "out.k12.inspect").exists():
            assert time.time() - t0 < 120, "no first checkpoint"
            time.sleep(0.05)
        pid = int(re.search(r"attempt=0 pid=(\d+)", log.read_text()).group(1))
        os.kill(pid, signal.SIGKILL)
        sup.communicate(timeout=120)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
    assert sup.returncode == 0, log.read_text()[-3000:]
    text = log.read_text()
    assert "# supervise: rc=137 attempt=1 restarting" in text
    port = run_tool(PS / "perk_budget.py", log)
    ref = run_tool(JS / "perk_budget.py", log)
    p, r = rows_of(port), rows_of(ref)
    ks = sorted(int(k) for k in re.findall(r"\[infer\] k=(\d+) posterior", text))
    assert sorted(p) == sorted(r) == sorted(set(ks)) and 12 in p
    for k in p:
        for c in ("sampling_s", "n_samples", "extend_s", "next_k"):
            assert p[k][c] == (r[k][c] or "-"), (k, c)
        assert p[k]["seed_s"] == "-"  # the small-graph regime seeds nothing
        assert float(p[k]["setup_s"]) >= 0
    assert re.search(r"# stages=\d+ restarts=1 ", port)
    assert re.search(r"# stages=\d+ restarts=0 ", ref)


def test_bench_real_graph_matches_jax_xla(toy, tmp_path):
    """The scorer benchmark on the k=17 checkpoint and its .map.mpz: the
    same graph, width and candidate lines and the same record's unit;
    K1's twin runs here, JAX's XLA scorer there."""
    jcopy = tmp_path / "scripts" / "bench_real_graph.py"
    jcopy.parent.mkdir()
    shutil.copy(JS / "bench_real_graph.py", jcopy)
    base = [toy / "out.k17.dbg", toy / "sim.json"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a: None)  # no cache dir
        port = run_tool(PS / "bench_real_graph.py", *base,
                        toy / "out.k17.map.mpz", "--device", "cpu")
        ref = run_tool(jcopy, *base, toy / "out.k17.map.mpz", "--xla")
    keep = lambda t: [ln.split(" (rescue")[0] for ln in t.splitlines()
                      if re.match(r"# (graph|\d+ distinct)", ln)]
    assert keep(port) == keep(ref) and len(keep(port)) == 2
    width = lambda t: re.search(r"\(width=(\d+)\)", t).group(1)
    assert width(port) == width(ref)
    rp, rr = json.loads(port.splitlines()[-1]), json.loads(ref.splitlines()[-1])
    assert rr["metric"] == rp["metric"] + "_xla" == "real_graph_scorings_per_sec_k17_xla"
    assert rp["unit"] == rr["unit"] and rp["value"] > 0
    assert (tmp_path / "bench_extra.json").exists()
    from dbgphmm_tpu_torch.scripts import bench_real_graph as B

    with pytest.raises(SystemExit, match="not ported"):
        B.main([*map(str, base), "--xla"])


@pytest.mark.parametrize("tool,args", [
    ("diag_mapping_quality.py", ["out.k16.dbg", "out.k16.map.mpz"]),
    ("diag_mapping_quality.py", ["out.k17.dbg", "out.k17.map.mpz"]),
    ("audit_hint_upconversion.py", ["out", "16", "17"]),
    ("diag_hint_relation.py", ["out", "16", "17"]),
    ("diag_hint_relation2.py", ["out", "16", "17"]),
])
def test_host_diagnostics_print_what_jax_prints(toy, tool, args):
    """Walk-consistency of a mapping, the replayed purge + extension and
    its upconverted hint sets against the next k's mapping, and the k ->
    k+1 relations: the same text to the last digit."""
    argv = [str(toy / a) if a.startswith("out") else a for a in args]
    port, ref = run_tool(PS / tool, *argv), run_tool(JS / tool, *argv)
    assert port == ref and port.count("\n") >= 3, port


def test_dbgviz_writes_the_same_page(toy, tmp_path):
    args = [toy / "out.final.dbg", "--inspect", toy / "out.final.inspect", "-o"]
    run_tool(PS / "dbgviz.py", *args, tmp_path / "port.html")
    run_tool(JS / "dbgviz.py", *args, tmp_path / "jax.html")
    page = (tmp_path / "port.html").read_text()
    assert page == (tmp_path / "jax.html").read_text() and "cytoscape" in page


def test_visualize_inspect_draws_the_same_plot(toy, tmp_path):
    import matplotlib.image as mpimg

    ins = [toy / "out.k16.inspect", toy / "out.k17.inspect"]
    out_p = run_tool(PS / "visualize_inspect.py", *ins, "-o", tmp_path / "p.png")
    out_j = run_tool(JS / "visualize_inspect.py", *ins, "-o", tmp_path / "j.png")
    assert out_p.replace("p.png", "") == out_j.replace("j.png", "")
    assert np.array_equal(mpimg.imread(tmp_path / "p.png"),
                          mpimg.imread(tmp_path / "j.png"))


# validate_large_n_mapping at toy size: the JAX tool's genome and reads
# are literals in its source, so its text is run with them replaced
GENOME = dict(unit_size=40, n_unit=4, end_length=60)
READS = dict(n_reads=4, length=200, min_length=100)


def test_validate_large_n_mapping_matches_jax(tmp_path):
    src = (JS / "validate_large_n_mapping.py").read_text()
    for old, new in (
        ("500, 80, 0, 0.02, 1, 300, 2, 0.02, 0",
         f"{GENOME['unit_size']}, {GENOME['n_unit']}, 0, 0.02, 1, "
         f"{GENOME['end_length']}, 2, 0.02, 0"),
        ("n_reads=4, length=4400", f"n_reads={READS['n_reads']}, "
                                   f"length={READS['length']}"),
        ("len(r.seq) >= 2000", f"len(r.seq) >= {READS['min_length']}"),
        ("assert n > 65536", "assert n > 0"),
    ):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    jtool = tmp_path / "validate_large_n_mapping.py"
    jtool.write_text(src)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from dbgphmm_tpu_torch.scripts import validate_large_n_mapping as V

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = V.main(["--device", "cpu"], genome=GENOME, reads=READS,
                         min_n=0)
        port = buf.getvalue()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.config, "update", lambda *a: None)  # no cache dir
            ref = run_tool(jtool)
    finally:
        torch.set_num_threads(n)
    pl, rl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(rl) == 10
    # genome, DBG size, reads and their lengths: equal; the DBG line's
    # build time may differ
    assert pl[0] == rl[0] and pl[2] == rl[2]
    assert pl[1].split(" (built")[0] == rl[1].split(" (built")[0]
    # the dense float64 oracle, printed to 0.1: the same
    assert pl[3].split("logp=")[1] == rl[3].split("logp=")[1]
    assert pl[-1] == rl[-1] == "# VERDICT: OK"
    assert res["ok"] and res["n_full"] > 0
    # the port's float64 dense scores against the JAX package's on the
    # same model and reads: 1e-9 relative
    from dbgphmm_tpu.multi_dbg import MultiDbg as JMultiDbg
    from dbgphmm_tpu.ops import to_device as jto_device
    from dbgphmm_tpu.ops.forward import forward_scores as jforward
    from dbgphmm_tpu.phmm.params import PHMMParams as JParams
    from dbgphmm_tpu.phmm.sample import SampleProfile, sample_positioned_reads_phmm
    from dbgphmm_tpu.seq import genome as jgenome
    from dbgphmm_tpu.ops import pad_reads as jpad_reads
    import jax.numpy as jnp

    g = jgenome.tandem_repeat_polyploid_with_unique_homo_ends(
        GENOME["unit_size"], GENOME["n_unit"], 0, 0.02, 1,
        GENOME["end_length"], 2, 0.02, 0)
    params = JParams.uniform(0.001)
    dbg = JMultiDbg.from_styled_seqs(40, list(g))
    reads = [r.seq for r in sample_positioned_reads_phmm(
        [s.seq for s in g], params,
        SampleProfile(n_reads=READS["n_reads"], length=READS["length"], seed=0),
        has_revcomp=False) if len(r.seq) >= READS["min_length"]]
    assert [len(r) for r in reads] == res["lengths"]
    codes, lens = jpad_reads(reads)
    ref64 = np.asarray(jforward(
        jto_device(dbg.to_phmm(params, mode="non_zero"), dtype=jnp.float64),
        jnp.asarray(codes), jnp.asarray(lens), renorm=True))
    np.testing.assert_allclose(res["lp_dense"], ref64, rtol=1e-9)
    # the frontier decode (float32) against that oracle: the kernel gate
    assert np.all(np.abs(res["lp_frontier"] - ref64)
                  <= REL_TOL * np.abs(ref64) + ABS_TOL)
    # the differential: float32 mapped, float64 dense, each against JAX's
    # printed value (3 decimals)
    diff = lambda ln: [float(x) for x in re.findall(r"=(-?\d+\.\d+)", ln)]
    dp, dr = diff(pl[8]), diff(rl[8])
    assert abs(dp[1] - dr[1]) <= 1e-3  # dense, float64 on both sides
    assert abs(dp[0] - dr[0]) <= REL_TOL * abs(dr[0]) + ABS_TOL


def test_compare_run_logs_finds_the_first_parting_stage(tmp_path):
    """compare_run_logs.py (how a port run is held against the JAX run's
    log): the JAX record against itself agrees at every stage, keeping the
    first attempt of a restarted stage; a copy with one `moved to p`
    shifted past the tolerance at k=42 parts there and nowhere before."""
    from dbgphmm_tpu_torch.scripts import compare_run_logs as C

    rec = REPO / "runs_n5_launch.log"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows, first = C.main([str(rec), str(rec)])
    assert first is None and len(rows) == 92 and all(r[-1] for r in rows)
    k40 = rows[0]
    assert k40[0] == 40 and len(k40[1]["moves"]) == 8 and k40[1]["opt"] == 8
    assert k40[1]["samples"] == 739 and k40[1]["moves"][-1][0] == -292932.568
    k41 = rows[1][1]
    assert k41["truth_lost"] and k41["maps"] == "regenerated"
    k44 = [r for r in rows if r[0] == 44][0]
    assert k44[3] == 2 and k44[1]["samples"] == 259  # the first attempt
    text = rec.read_text().replace("moved to p=-43580.527", "moved to p=-43581.527")
    (tmp_path / "b.log").write_text(text)
    with contextlib.redirect_stdout(io.StringIO()):
        rows, first = C.main([str(tmp_path / "b.log"), str(rec)])
    assert first == 42
    with contextlib.redirect_stdout(io.StringIO()):
        _rows, first = C.main([str(tmp_path / "b.log"), str(rec), "--rel", "1e-4"])
    assert first is None
