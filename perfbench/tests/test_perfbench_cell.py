"""A cell added by files and BENCHMARK.json entries alone (a toy
configuration, ``conftest.toy_bench``) runs through the harness on the CPU
with the program's plain versions; its control and each fault planted in
the timed path come out not correct.  The toy graph is below every size
threshold of the program, so its decodes are the dense ones; the faults
are planted in the calls the timed path makes there."""

import numpy as np
import pytest
import torch

from perfbench import checks, inputs, program, run

SEED = 3_000_000_019  # above 2**31


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def _run(toy, cell, traced=False):
    root, bench = toy
    return run.run_cell(run.Cell(cell, bench, root), SEED, 0.01, traced, "cpu",
                        log=lambda *a: None)


def test_toy_cells_run_and_are_correct(toy, tmpdir_env):
    res = _run(toy, "toy.k16_map")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "reads_mapped_per_s"}
    assert res["attempted"] == 6 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_toy_infer_traced(toy, tmpdir_env):
    res = _run(toy, "toy.k17_run", traced=True)
    assert res["correct"], res["checks"]
    assert {"host_s.stage", "decode_s.stage", "refine_s.stage",
            "device_idle_pct.stage"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and res["breakdown"]["idle_gaps"]


def test_control_is_not_correct(toy):
    root, bench = toy
    from perfbench import control

    for cell in ("toy.k17_run", "toy.k16_map"):
        c = run.Cell(cell, bench, root)
        for _seed, nums in control.readings(c, [SEED], torch.device("cpu")):
            assert checks.judge(nums["program"], c.limits), nums
            assert not checks.judge(nums["control"], c.limits), nums


def _half_batch(fn):
    """The decode of the first half of the reads; the rest get the first
    half's rows and the mean of its log-likelihoods."""
    def wrapped(dm, codes, lens, *a, **kw):
        B = codes.shape[0]
        h = max(1, B // 2)
        logp, *rest = fn(dm, codes[:h], lens[:h], *[
            x[:h] if torch.is_tensor(x) and x.shape[:1] == (B,) else x
            for x in a], **kw)
        fill = lambda t: torch.cat([t, t[torch.arange(B - h) % h]])
        return (torch.cat([logp, logp.mean().expand(B - h)]),
                *[fill(t) for t in rest])
    return wrapped


def _unchanged(fn):
    """The refine returns the sets it was given, unscored."""
    def wrapped(dm, codes, lens, hint, *a, **kw):
        return (torch.zeros(codes.shape[0], dtype=dm.dtype), hint,
                torch.zeros(hint.shape, dtype=dm.dtype))
    return wrapped


def _sets_unchanged(fn):
    """The refine returns the sets it was given, with the right
    log-likelihoods."""
    def wrapped(dm, codes, lens, hint, *a, **kw):
        logp, *_rest = fn(dm, codes, lens, hint, *a, **kw)
        return logp, hint, torch.zeros(hint.shape, dtype=dm.dtype)
    return wrapped


def _sets_shifted(fn):
    """The decode's sets one read position late, log-likelihoods right."""
    def wrapped(*a, **kw):
        logp, freqs, nodes, logs = fn(*a, **kw)
        return logp, freqs, nodes.roll(1, 1), logs.roll(1, 1)
    return wrapped


def _top_dropped(fn):
    """The decode's sets without their best node, the rest right."""
    def wrapped(*a, **kw):
        logp, freqs, nodes, logs = fn(*a, **kw)
        nodes = torch.cat([nodes[..., 1:], torch.full_like(nodes[..., :1], -1)],
                          -1)
        logs = torch.cat([logs[..., 1:], torch.full_like(logs[..., :1],
                                                         float("-inf"))], -1)
        return logp, freqs, nodes, logs
    return wrapped


def _altered_score(fn):
    def wrapped(*a, **kw):
        scores = fn(*a, **kw)
        scores[0].likelihood += 0.5
        return scores
    return wrapped


def _altered_read(fn):
    """The longest read's log-likelihood off by half a nat (the check's
    sample always holds the longest read)."""
    def wrapped(dm, codes, lens, *a, **kw):
        logp, *rest = fn(dm, codes, lens, *a, **kw)
        logp = logp.clone()
        logp[int(torch.argmax(lens))] += 0.5
        return (logp, *rest)
    return wrapped


FAULTS = {  # name: (cell, [(posterior attribute, fault)])
    "refine_unchanged": ("toy.k17_run", [("mappings_refine", _unchanged)]),
    "refine_sets_unchanged": ("toy.k17_run", [("mappings_refine",
                                               _sets_unchanged)]),
    "decode_top_dropped": ("toy.k17_run", [("node_freqs_and_mappings",
                                            _top_dropped)]),
    "map_sets_shifted": ("toy.k16_map", [("node_freqs_and_mappings",
                                          _sets_shifted)]),
    "half_batch": ("toy.k17_run", [("node_freqs_and_mappings", _half_batch),
                                   ("mappings_refine", _half_batch)]),
    "score_altered": ("toy.k17_run", [("score_candidates", _altered_score)]),
    "map_half_batch": ("toy.k16_map", [("node_freqs_and_mappings",
                                        _half_batch)]),
    "map_read_altered": ("toy.k16_map", [("node_freqs_and_mappings",
                                          _altered_read)]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_timed_path_is_not_correct(toy, monkeypatch, tmpdir_env,
                                            fault):
    cell, plants = FAULTS[fault]
    post = program.module("multi_dbg.posterior")
    for attr, make in plants:
        monkeypatch.setattr(post, attr, make(getattr(post, attr)))
    res = _run(toy, cell)
    assert not res["correct"], res["checks"]


def test_reads_follow_the_upstream_rule():
    cfg = run.load_json(run.ROOT / "configs" / "n4.json")
    a, b = inputs.reads(cfg, 7), inputs.reads(cfg, SEED)
    assert a == inputs.reads(cfg, 7) and a != b
    size = sum(len(h) for h in inputs.genome(cfg))
    for rs in (a, b):  # 10x coverage, the last read crossing it
        n = sum(len(r) for r in rs)
        assert n - len(rs[-1]) < 10 * size <= n
        assert max(len(r) for r in rs) <= 10_000 * 1.01
        assert min(len(r) for r in rs) < 9_000  # cut at a haplotype's end
