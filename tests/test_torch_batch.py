"""The port's candidate-batched likelihoods (dbgphmm_tpu_torch.ops.batch)
against the JAX package's ``candidate_log_likelihoods``, in float64 on the
CPU: the dense, ``map_nodes`` and ``positions`` branches on the small
diploid of tests/test_posterior.py and 5 neighbours of its truth, to 1e-9
relative; and one stacked pass equal to single-candidate passes."""

import numpy as np
import pytest

from dbgphmm_tpu.ops.batch import candidate_log_likelihoods as jax_cll
from dbgphmm_tpu.ops.sparse import precompute_positions as jax_positions
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import posterior as TP
from dbgphmm_tpu_torch.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu_torch.ops.batch import _bucket, candidate_log_likelihoods
from dbgphmm_tpu_torch.ops.forward import pad_reads
from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.phmm.template import make_template

from test_torch_posterior import (  # noqa: F401
    one_torch_thread, perfect_reads, small_diploid)


@pytest.fixture(scope="module")
def case():
    """The port's graph, reads, template and mapping; 6 candidates (the
    truth and 5 neighbours); the mapping as [B, L, A] node ids."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, list(g))
    reads = perfect_reads(g, coverage=6, read_len=14)
    params = PHMMParams.uniform(0.001)
    tpl = make_template(dbg, params)
    cands = [dbg.get_copy_nums()] + [cn for cn, _i in to_short_neighbors(dbg, 8, 2)[:5]]
    codes, lens = pad_reads(list(reads))
    maps = TP.generate_mappings(dbg, params, reads, "cpu")
    mn = pad_mappings(maps, codes.shape[1], max(a.shape[1] for a in maps.nodes))
    return tpl, cands, codes, lens, mn


@pytest.mark.parametrize("branch", ["dense", "map_nodes", "positions"])
def test_candidate_log_likelihoods_match_jax(case, branch):
    tpl, cands, codes, lens, mn = case
    models = [tpl.model_for(cn) for cn in cands]
    kw, jkw = {}, {}
    if branch == "map_nodes":
        kw = jkw = dict(map_nodes=mn)
    elif branch == "positions":
        kw = dict(positions=precompute_positions(
            mn, tpl.parent_idx, parent_exists=tpl.parent_exists))
        jkw = dict(positions=jax_positions(mn, tpl.parent_idx,
                                           parent_exists=tpl.parent_exists))
    got = candidate_log_likelihoods(models, codes, lens, "cpu", **kw)
    ref = jax_cll(models, codes, lens, **jkw)
    assert got.shape == (len(cands),) and got.dtype == np.float64
    assert np.isfinite(got[0]) and got[0] == got.max()  # the truth is best
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-9, atol=0)


def test_stacked_pass_equals_single_candidates(case):
    """Candidates stacked on a leading axis (6 padded to 8) give each
    candidate's single-candidate pass, in every branch."""
    tpl, cands, codes, lens, mn = case
    assert _bucket(6) == 8 and _bucket(1) == 1
    models = [tpl.model_for(cn) for cn in cands]
    for kw in ({}, {"map_nodes": mn}):
        stacked = candidate_log_likelihoods(models, codes, lens, "cpu", **kw)
        single = [candidate_log_likelihoods([m], codes, lens, "cpu", **kw)[0]
                  for m in models]
        np.testing.assert_allclose(stacked, single, rtol=1e-12, atol=0)


def test_batch_scorer_sub_batches(case, monkeypatch):
    """BatchScorer (sample_posterior without mappings) scores in
    sub-batches: the same sums at a sub-batch of 4 as in one call."""
    tpl, cands, codes, lens, _mn = case
    scorer = TP.BatchScorer(tpl, codes, lens, "cpu")
    whole, ok = scorer.scores_detailed(cands)
    monkeypatch.setattr(TP.BatchScorer, "SUB", 4)
    parts, _ = scorer.scores_detailed(cands)
    assert ok.all() and scorer.n_reads == codes.shape[0]
    np.testing.assert_allclose(parts, whole, rtol=1e-12, atol=0)
    np.testing.assert_allclose(whole, jax_cll([tpl.model_for(cn) for cn in cands],
                                              codes, lens), rtol=1e-9)
