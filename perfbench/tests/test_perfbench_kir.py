"""A KIR-shaped toy cell: a diploid tandem repeat of two units twice the
read length, fragment reads, the ``infer`` entry to k+1, with the
program's and the check's size thresholds at 0 so that every stage seeds,
as ``kir.k41_run`` does above 32,768 full edges.  It is correct through
``run.run_cell``, a refine that drops one read's seeded sets is not, and a
traced run reports the per-layer metrics of the climb's and the scorer
set-up's parts."""

import gzip
import json
import math

import pytest

from perfbench import run
from perfbench.tests import test_perfbench_seeded as seeded_tests
from perfbench.tests.conftest import toy_bench

SEED = 3_000_000_033  # above 2**31
CELL = "kirtoy.k13_run"
UNIT, READ = 40, 20  # no read spans a unit
SPLIT = ("rescue_network_s.stage", "rescue_paths_s.stage",
         "rescue_cycles_s.stage", "setup_template_s.stage",
         "setup_positions_s.stage", "setup_streams_s.stage")


@pytest.fixture(scope="module")
def kir_toy(tmp_path_factory):
    """(root, bench) of the toy harness with the KIR-shaped cell added."""
    from dbgphmm_tpu_torch.multi_dbg import MultiDbg, output
    from dbgphmm_tpu_torch.seq import genome as G

    root = tmp_path_factory.mktemp("kirbench") / "perfbench"
    root.mkdir()
    bench = toy_bench(root)
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(UNIT, 2, 0, 0.02, 1,
                                                        20, 2, 0.02, 0)
    data = root / "data" / "kirtoy"
    data.mkdir(parents=True)
    (data / "genome.txt").write_text("\n".join(str(s) for s in g) + "\n")
    with gzip.open(data / "draft.dbg.gz", "wt") as f:
        f.write(output.to_dbg_string(MultiDbg.from_styled_seqs(12, list(g))))
    cfg = {"name": "kirtoy", "source": "test only",
           "dataset": {"genome": "data/kirtoy/genome.txt",
                       "draft": "data/kirtoy/draft.dbg.gz",
                       "reads": {"kind": "fragment", "coverage": 6,
                                 "read_length": READ, "p_error": 0.001,
                                 "min_length": 12}},
           "settings": {"p_error": 0.001, "p_infer": 0.001,
                        "genome_size": sum(len(s.seq) for s in g),
                        "genome_size_sigma": 50, "p0": 0.99, "max_iter": 1},
           "reduced": {}, "assumed": {}}
    (root / "configs" / "kirtoy.json").write_text(json.dumps(cfg))
    (root / "traffic" / "k13_run.json").write_text(json.dumps(
        {"entry": "infer", "k_max": 13, "check_candidates": 2,
         "read_sets": 2}))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"refine_ll_rel": 1e-9, "post_gap": 1e-9, "score_rel": 1e-9,
         "host_gap": 1e-9, "extend_faults": 0}))
    bench["configs"].append({"name": "kirtoy", "source": "test only",
                             "file": f"{root.name}/configs/kirtoy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "kirtoy",
                               "traffic": "k13_run", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kir.k41_run" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return root, bench


@pytest.fixture
def seeds(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return seeded_tests._thresholds(monkeypatch)


def _run(kir_toy, traced=False):
    root, bench = kir_toy
    return run.run_cell(run.Cell(CELL, bench, root), SEED, 0.01, traced,
                        "cpu", log=lambda *a: None)


def test_kir_toy_reads_are_shorter_than_a_unit(kir_toy):
    from perfbench import inputs

    root, bench = kir_toy
    cell = run.Cell(CELL, bench, root)
    reads = inputs.reads(cell.cfg, SEED, 0, root)
    assert len(reads) > 10 and max(map(len, reads)) < UNIT
    assert cell.limits.keys() == json.loads(
        (run.ROOT / "limits" / "kir.k41_run.json").read_text()).keys()


def test_kir_toy_cell_is_correct(kir_toy, seeds):
    res = _run(kir_toy)
    assert seeds, "no stage was seeded"
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def test_kir_toy_with_a_read_dropped_is_not_correct(kir_toy, seeds,
                                                   monkeypatch):
    from perfbench import program

    post = program.module("multi_dbg.posterior")
    monkeypatch.setattr(post, "mappings_refine",
                        seeded_tests._first_set_dropped(post.mappings_refine))
    res = _run(kir_toy)
    assert seeds
    assert not res["correct"], res["checks"]
    gap = res["checks"]["post_gap"]
    assert gap["value"] > gap["limit"]


def test_kir_toy_traced_reports_the_split(kir_toy, seeds):
    res = _run(kir_toy, traced=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in SPLIT + ("neighbors_s.stage", "scorer_setup_s.stage"):
        assert math.isfinite(got[name]["value"]), name
        assert got[name]["value"] >= 0, name
    # the parts sum to their parent less its own time: under the profiler
    # ~14 us a span, some tenths of a millisecond a toy stage
    for parts, whole in ((SPLIT[:3], "neighbors_s.stage"),
                         (SPLIT[3:], "scorer_setup_s.stage")):
        rest = got[whole]["value"] - sum(got[n]["value"] for n in parts)
        assert 0 <= rest < 1e-3, (whole, rest)
