"""Every configuration, traffic mix, limit, metric and kernel count that
BENCHMARK.json names is a file of its own that the harness finds by name,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench import run

BENCH = json.loads((run.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = run.Cell(cell, BENCH)
    assert c.cfg["name"] == cell.split(".")[0]
    mod = run.entry_module(c.traffic["entry"])
    assert callable(mod.numbers) and mod.Entry.work_unit
    assert set(c.limits) and all(v is not None for v in c.limits.values())
    assert {m["name"] for m in c.e2e} >= {"setup_s"} and len(c.e2e) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    mod = run.load_module(run.ROOT / "metrics" / f"{metric}.py")
    ctx = run.Context("none", 1.0, 2.0, 3)
    assert mod.read(ctx) is None or metric == "setup_s"


def test_unknown_entry_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="unknown traffic entry"):
        run.entry_module("no_such_entry")


def test_rooflines_load_by_name():
    rls = run.rooflines()
    assert set(rls) == {"a1", "r1", "r2"}
    for rl in rls.values():
        assert len(rl.HOOK) == 2 and re.compile(rl.KERNEL)
        assert callable(rl.record) and callable(rl.work)


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cfgs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (run.REPO / c["file"]).is_file()
        assert json.loads((run.REPO / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (run.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
    for w in BENCH["workloads"]:  # every cell reports setup_s, another
        c = run.Cell(w["name"], BENCH)  # end-to-end metric, a per-layer one
        assert len(c.e2e) >= 2 and c.per_layer
