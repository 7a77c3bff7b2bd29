"""The per-layer metrics read from the program's own spans
(``perfbench/stage_split.py``): the toy traced cells report every one that
applies to their entry, and a program without the spans gives none."""

import math

import pytest

from perfbench import run

SEED = 3_000_000_021
STAGE = ("neighbors_s.stage", "prior_s.stage", "extend_s.stage",
         "map_host_s.stage", "fetch_s.stage", "fetch_kept_pct.stage",
         "untraced_s.stage")
MAP = ("seed_index_s.map", "seed_hits_s.map", "seed_chain_s.map",
       "seed_rows_s.map", "map_host_s.map", "fetch_s.map",
       "fetch_kept_pct.map", "untraced_s.map")


@pytest.mark.parametrize("cell, names", [("toy.k17_run", STAGE),
                                         ("toy.k16_map", MAP)])
def test_toy_traced_cells_report_the_program_spans(toy, tmp_path,
                                                   monkeypatch, cell, names):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root, bench = toy
    res = run.run_cell(run.Cell(cell, bench, root), SEED, 0.01, True, "cpu",
                       log=lambda *a: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(names) <= set(got)
    for n in names:
        assert math.isfinite(got[n]["value"]) and got[n]["value"] >= 0, n
    assert 0 < got[names[-2]]["value"] <= 100  # fetch_kept_pct
    other = MAP if names is STAGE else STAGE
    assert not set(other) & set(got)


@pytest.mark.parametrize("name", STAGE + MAP)
def test_a_program_without_the_spans_gives_nothing(name):
    """The parent's StageTimes dicts lack the fields: no value, no error."""
    entry = "infer" if name.endswith(".stage") else "map"
    old = {"k": 40, "seed_s": 1.0, "decode_s": 0.5, "refine_s": 0.2,
           "setup_s": 0.3, "score_s": 0.1, "n_scorings": 10, "n_rescued": 0,
           "wall_s": 2.5, "host_s": 0.4, "scorings_per_s": 100.0}
    ctx = run.Context(entry, 1.0, 2.0, 3, stage_times=[old, old])
    mod = run.load_module(run.ROOT / "metrics" / f"{name}.py")
    assert mod.read(ctx) is None
