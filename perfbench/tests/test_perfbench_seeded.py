"""The ``infer`` entry's check of a seeded k-stage, on the toy cell of
``conftest.toy_bench`` with the program's and the check's size thresholds
at 0, so that every stage maps by seeding then the refine (``hint_regen``
off), as above 32,768 full edges: the run is correct, no read is taken as
gated where the program cannot gate, a fault in the seeded refine still
fails the run, and a read that seeding leaves empty shows in the reading
``seed_loss``."""

import numpy as np
import pytest
import torch

from perfbench import checks, inputs, program, run
from perfbench.reference import phmm as P

SEED = 3_000_000_019  # above 2**31
CELL = "toy.k17_run"


def _thresholds(mp):
    """Every size threshold at 0, in the program and in the check, so that
    the toy's maps seed.  Returns the list that each seeding call extends."""
    mp.delenv("DBGPHMM_SEED_MAPPING", raising=False)
    post = program.module("multi_dbg.posterior")
    for mod in (post, checks):
        mp.setattr(mod, "DENSE_COMPUTE_MAX_NODES", 0)
        mp.setattr(mod, "DENSE_MAPPING_MAX_NODES", 0)
    seeds, orig = [], post.seed_mappings_arrays

    def counted(*a, **kw):
        seeds.append(1)
        return orig(*a, **kw)

    mp.setattr(post, "seed_mappings_arrays", counted)
    return seeds


@pytest.fixture
def seeded(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return _thresholds(monkeypatch)


def _unit(toy):
    """(cell, entry module, entry, captured unit) of the toy infer cell."""
    root, bench = toy
    cell = run.Cell(CELL, bench, root)
    mod = run.entry_module(cell.traffic["entry"], root)
    entry = mod.Entry(cell.cfg, cell.traffic,
                      inputs.draft_text(cell.cfg, root), torch.device("cpu"))
    return cell, mod, entry, entry.unit(inputs.reads(cell.cfg, SEED, 0, root))


@pytest.fixture(scope="module")
def seeded_unit(toy, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("seeded")))
        seeds = _thresholds(mp)
        out = _unit(toy)
    assert seeds, "no stage was seeded"
    return out


def _numbers(cell, mod, entry, got, control=None, **traffic):
    return checks.numbers(mod, entry, got, cell.cfg, {**cell.traffic, **traffic},
                          SEED, torch.device("cpu"), control)


def test_seeded_toy_cell_is_correct(toy, seeded):
    root, bench = toy
    res = run.run_cell(run.Cell(CELL, bench, root), SEED, 0.01, False, "cpu",
                       log=lambda *a: None)
    assert seeded, "no stage was seeded"
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def test_only_the_seeded_toy_stages_count_as_seeded(toy, seeded_unit,
                                                    tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    for got, want in ((seeded_unit[3], True), (_unit(toy)[3], False)):
        for _dbg, _post, maps in got["stages"]:
            assert seeded_unit[1]._seeded(got["calls"], maps) == want


def test_seeded_stage_is_not_gated(seeded_unit, monkeypatch):
    """Each read's log-likelihood moved past the midpoint from its seeded
    sets' forward toward the full one: the program re-decodes nothing in a
    seeded map, so the check holds every read to its seeded sets, decodes
    none from scratch (which has no reference above 32,768 full edges) and
    runs the forward over the full graph on ``SEED_CHECK_READS`` reads
    only."""
    cell, mod, entry, got = seeded_unit
    _thresholds(monkeypatch)
    p = P.Params(cell.cfg["settings"]["p_error"])
    codes, lens = P.encode(got["reads"])
    moved = []
    for dbg, _post, maps in got["stages"]:
        copies, hint = program.call_of(got["calls"], maps)
        g = program.graph_of(dbg, copies)
        within, dense = checks.rows(g, [(None, p)] * 2, [hint, None], codes,
                                    lens)
        assert (dense >= within - 1e-9).all()
        monkeypatch.setattr(maps, "read_logps",
                            within + 0.75 * (dense - within))
        moved.append(checks.gap(maps.read_logps, within))
    # the parent's gate would send every read whose forward gains from the
    # full graph back to a decode from scratch, and raise there
    assert max(moved) > 0
    scratch = []
    orig = checks.posteriors

    def noted(g, params, codes, lens, sets=None, dtype=torch.float64):
        scratch.append(sets is None)
        return orig(g, params, codes, lens, sets, dtype)

    full, orig_forward = [], P.forward

    def noted_forward(m, codes, lens, sets=None):
        if sets is None:
            full.append(codes.shape[0])
        return orig_forward(m, codes, lens, sets)

    monkeypatch.setattr(checks, "posteriors", noted)
    monkeypatch.setattr(P, "forward", noted_forward)
    nums = _numbers(cell, mod, entry, got)["program"]
    assert scratch and not any(scratch)
    assert full == [min(mod.SEED_CHECK_READS, len(got["reads"]))] * len(moved)
    assert nums["refine_ll_rel"] == pytest.approx(max(moved), rel=1e-9)
    assert nums["decode_ll_rel"] == 0.0


def _first_set_dropped(fn):
    """The refine's output without the first read's per-base sets."""
    def wrapped(*a, **kw):
        logp, nodes, logs = fn(*a, **kw)
        nodes, logs = nodes.clone(), logs.clone()
        nodes[0] = -1
        logs[0] = float("-inf")
        return logp, nodes, logs
    return wrapped


def test_seeded_refine_fault_is_not_correct(toy, seeded, monkeypatch):
    root, bench = toy
    post = program.module("multi_dbg.posterior")
    monkeypatch.setattr(post, "mappings_refine",
                        _first_set_dropped(post.mappings_refine))
    res = run.run_cell(run.Cell(CELL, bench, root), SEED, 0.01, False, "cpu",
                       log=lambda *a: None)
    assert seeded
    assert not res["correct"], res["checks"]
    post_gap = res["checks"]["post_gap"]
    assert post_gap["value"] > post_gap["limit"]


def _longest_unseeded(fn):
    """The seeder with the longest read's candidate rows all empty."""
    def wrapped(dbg, reads, *a, **kw):
        arrs = fn(dbg, reads, *a, **kw)
        j = max(range(len(reads)), key=lambda i: len(reads[i]))
        arrs[j] = arrs[j].copy()
        arrs[j][:] = -1
        return arrs
    return wrapped


def test_seed_loss_reads_what_seeding_misses(toy, seeded_unit, seeded,
                                             monkeypatch):
    """A sound seeded unit's ``seed_loss`` is finite (at k=17 the toy's
    seeding misses one read's path by some hundreds of nats), and one whose
    seeder leaves the longest read (always among those drawn) with no
    candidate reads it as infinite (the largest float); the limits, which hold the program to
    its own seeded sets, do not see that."""
    cell, mod, entry, got = seeded_unit
    sound = _numbers(cell, mod, entry, got)["program"]
    assert 0.0 <= sound["seed_loss"] < float("inf")
    post = program.module("multi_dbg.posterior")
    monkeypatch.setattr(post, "seed_mappings_arrays",
                        _longest_unseeded(post.seed_mappings_arrays))
    cell, mod, entry, bad = _unit(toy)
    bad_loss = _numbers(cell, mod, entry, bad)["program"]["seed_loss"]
    assert bad_loss == np.finfo(np.float64).max
