"""The port's posterior inference (dbgphmm_tpu_torch.multi_dbg.posterior)
against the JAX package on the small diploid of tests/test_posterior.py.

Tests with the ``seeded`` fixture push both packages onto the seeded
regime by setting DENSE_COMPUTE_MAX_NODES to 0 in each (monkeypatch; no
file of the JAX package changes), so the JAX reference runs the same path
as the port: seeding + refine, mapped candidate scoring (float64 XLA
there, the K1 kernel's float64 twin here), hill climb, purge and
extension.  The small-graph tests leave the thresholds as they are and
run the from-scratch decodes (dense and sparse-adaptive) and, without
mappings, the dense batch scorer, on both sides.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dbgphmm_tpu.multi_dbg.posterior as JP
import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu import multi_dbg as jax_multi_dbg
from dbgphmm_tpu.multi_dbg import neighbors as jax_neighbors
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.seq import collection as jax_collection
from dbgphmm_tpu.seq import genome as jax_genome
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch.multi_dbg import neighbors as port_neighbors
from dbgphmm_tpu_torch.multi_dbg import output as TO
from dbgphmm_tpu_torch.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.seq import collection as port_collection
from dbgphmm_tpu_torch.seq import genome as port_genome

MultiDbg = port_multi_dbg.MultiDbg
PHMMParams = port_params.PHMMParams


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run thousands of tiny PyTorch ops; with one intra-op
    thread per test process they do not oversubscribe the cores when the
    suite runs in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_diploid(jax=False):
    """The two haplotypes, as the JAX package's objects or the port's."""
    col, gen = ((jax_collection, jax_genome) if jax
                else (port_collection, port_genome))
    h1 = b"TTAGGCTTCGATCGAATGCC"
    h2 = b"TTAGGCTTGGATCGAATGCC"
    return gen.Genome([col.StyledSequence.linear(h1),
                       col.StyledSequence.linear(h2)])


def perfect_reads(genome, coverage=10, read_len=12, seed=0, jax=False):
    rng = np.random.default_rng(seed)
    reads = []
    for s in genome:
        n = int(len(s.seq) * coverage / read_len)
        for _ in range(n):
            st = rng.integers(0, len(s.seq) - read_len + 1)
            reads.append(s.seq[st : st + read_len])
    col = jax_collection if jax else port_collection
    return col.ReadCollection(reads)


@pytest.fixture
def seeded(monkeypatch):
    monkeypatch.setattr(JP, "DENSE_COMPUTE_MAX_NODES", 0)
    monkeypatch.setattr(TP, "DENSE_COMPUTE_MAX_NODES", 0)


def test_infer_by_extension_matches_jax(seeded):
    """Two k-steps (k=8 -> 9) in both packages, from a draft whose copy
    numbers zero a true edge (so the k=8 climb has rescue moves to score):
    the same max_copy_nums at every stage, the same final copy numbers, and
    the likelihoods of the samples both final posteriors hold agree to 1e-6
    relative."""
    results = {}
    for name, jax, dbg_mod, params_mod, run in (
        ("jax", True, jax_multi_dbg, jax_params,
         lambda **kw: JP.infer_posterior_by_extension(**kw)),
        ("torch", False, port_multi_dbg, port_params,
         lambda **kw: TP.infer_posterior_by_extension(device="cpu", **kw)),
    ):
        # each package runs on its own objects, built from the same inputs
        g = small_diploid(jax)
        reads = perfect_reads(g, coverage=12, read_len=16, seed=1, jax=jax)
        params = params_mod.PHMMParams.uniform(0.001)
        draft = dbg_mod.MultiDbg.from_styled_seqs(8, list(g))
        assert draft.get_copy_nums() == [2, 1, 1, 2]
        draft.set_copy_nums([1, 0, 1, 1])  # a +-1 cycle away from the truth
        stages = []
        dbg_final, post, _paths, _maps = run(
            k_max=9, dbg_init=draft,
            param_infer=params, param_error=params, reads=reads,
            genome_size_expected=g.genome_size(), genome_size_sigma=5,
            max_iter=10, p0=0.8, n_haplotypes=2,
            on_iter=lambda d, p, pa, m: stages.append((d.k, p.max_copy_nums())),
        )
        results[name] = (stages, dbg_final.get_copy_nums(), post)
    (st_j, cn_j, post_j), (st_t, cn_t, post_t) = results["jax"], results["torch"]
    assert [k for k, _ in st_t] == [8, 9]
    assert st_t[0][1] != [1, 0, 1, 1]  # the k=8 climb moved
    assert st_t == st_j
    assert cn_t == cn_j
    shared = [s for s in post_t.samples if post_j.contains(s.copy_nums)]
    assert sum(np.isfinite(s.score.likelihood) for s in shared) >= 3
    for s in shared:
        ref = post_j.find(s.copy_nums).score
        assert s.score.genome_size == ref.genome_size
        assert s.score.prior == pytest.approx(ref.prior, rel=1e-12)
        np.testing.assert_allclose(s.score.likelihood, ref.likelihood, rtol=1e-6)
        np.testing.assert_allclose(s.score.p(), ref.p(), rtol=1e-6)


def test_sample_posterior_recovers_from_corruption(seeded):
    """The port's hill climb, started from a corrupted neighbour of the
    truth, climbs back to the true copy numbers (as the JAX package's
    tests/test_posterior.py does)."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, list(g))
    reads = perfect_reads(g, coverage=10, read_len=14)
    params = PHMMParams.uniform(0.001)
    true_cn = dbg.get_copy_nums()
    work = dbg.copy()
    work.set_copy_nums(to_short_neighbors(dbg, 8, 2)[0][0])
    assert work.get_copy_nums() != true_cn

    mappings = TP.generate_mappings(work, params, reads, "cpu")
    post = TP.sample_posterior(work, params, reads, mappings, g.genome_size(),
                               5, "cpu", rescue_only=False, max_iter=10)
    assert post.max_copy_nums() == true_cn


def _same_mappings(got, ref):
    """Port mappings against the JAX package's: read likelihoods to 1e-9
    relative, identical node sets, finite log-probabilities to 1e-8."""
    assert got.n_reads() == ref.n_reads()
    np.testing.assert_allclose(got.read_logps, ref.read_logps, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.anchor_logps, ref.anchor_logps, rtol=1e-9,
                               atol=0)
    assert got.stages_since_anchor == ref.stages_since_anchor
    for a, b, la, lb in zip(got.nodes, ref.nodes, got.logps, ref.logps):
        np.testing.assert_array_equal(a, b)
        fin = np.isfinite(lb)
        np.testing.assert_array_equal(np.isfinite(la), fin)
        np.testing.assert_allclose(la[fin], lb[fin], rtol=0, atol=1e-8)


def _same_samples(got, ref, rtol=1e-6):
    """The same samples in the same order, likelihoods to ``rtol``."""
    assert [s.copy_nums for s in got.samples] == [s.copy_nums for s in ref.samples]
    for s in got.samples:
        np.testing.assert_allclose(s.score.likelihood,
                                   ref.find(s.copy_nums).score.likelihood,
                                   rtol=rtol)


def _both(build):
    """build(side) on the JAX package's objects and on the port's; side
    carries the modules and ``jax`` (True / False)."""
    out = {}
    for jax in (True, False):
        side = SimpleNamespace(
            jax=jax, P=JP if jax else TP,
            MultiDbg=(jax_multi_dbg if jax else port_multi_dbg).MultiDbg,
            PHMMParams=(jax_params if jax else port_params).PHMMParams,
            col=jax_collection if jax else port_collection,
            gen=lambda **kw: JP.generate_mappings(**kw) if jax else
            TP.generate_mappings(device="cpu", **kw))
        out["jax" if jax else "torch"] = build(side)
    return out["torch"], out["jax"]


def test_small_graph_without_hint_is_decoded_from_scratch():
    """Below DENSE_MAPPING_MAX_NODES a call without a hint runs the dense
    decode: the JAX package's mapping, and its own anchor."""
    def build(S):
        g = small_diploid(S.jax)
        dbg = S.MultiDbg.from_styled_seqs(8, list(g))
        assert dbg.n_edges_full() <= TP.DENSE_MAPPING_MAX_NODES
        return S.gen(dbg=dbg, params=S.PHMMParams.uniform(0.001),
                     reads=perfect_reads(g, jax=S.jax))
    got, ref = _both(build)
    _same_mappings(got, ref)
    np.testing.assert_array_equal(got.anchor_logps, got.read_logps)
    assert got.stages_since_anchor == 0


def test_generate_mappings_sane():
    """n_active=8: node freqs account for ~all read bases; the JAX
    package's mapping (tests/test_posterior.py)."""
    def build(S):
        g = small_diploid(S.jax)
        reads = perfect_reads(g, coverage=5, read_len=12, jax=S.jax)
        dbg = S.MultiDbg.from_styled_seqs(8, list(g))
        return S.gen(dbg=dbg, params=S.PHMMParams.uniform(0.001), reads=reads,
                     n_active=8), dbg, reads
    (got, dbg, reads), (ref, _d, _r) = _both(build)
    assert got.n_reads() == len(reads)
    freqs = got.to_node_freqs(dbg.n_edges_full())
    assert freqs.sum() == pytest.approx(reads.total_bases(), rel=0.05)
    _same_mappings(got, ref)


def test_generate_mappings_score_ratio_trims_width():
    """The ratio window trims the width far below the cap and keeps each
    position's slots within active_node_max_ratio of its best."""
    def build(S):
        g = small_diploid(S.jax)
        return S.gen(dbg=S.MultiDbg.from_styled_seqs(8, list(g)),
                     params=S.PHMMParams.uniform(0.001),
                     reads=perfect_reads(g, coverage=5, read_len=12, jax=S.jax))
    got, ref = _both(build)
    assert max(n.shape[1] for n in got.nodes) <= 32
    ratio = PHMMParams.uniform(0.001).active_node_max_ratio
    for nodes, logps in zip(got.nodes, got.logps):
        for j in range(nodes.shape[0]):
            lp = logps[j][nodes[j] >= 0]
            assert lp.size == 0 or lp.max() - lp.min() <= ratio + 1e-6
    _same_mappings(got, ref)


def test_generate_mappings_ratio_keeps_ambiguous_alternatives():
    """A read of one bare unit of a 2-copy repeat: every position keeps a
    slot; the JAX package's mapping."""
    unit = b"ACGTTGCA"

    def build(S):
        dbg = S.MultiDbg.from_styled_seqs(
            4, [S.col.StyledSequence.linear(b"TTT" + unit * 2 + b"GGG")])
        return S.gen(dbg=dbg, params=S.PHMMParams.uniform(0.001),
                     reads=S.col.ReadCollection([unit]))
    got, ref = _both(build)
    assert all((got.nodes[0][j] >= 0).sum() >= 1
               for j in range(got.nodes[0].shape[0]))
    _same_mappings(got, ref)


def test_generate_mappings_read_chunking():
    """A chunked decode (read_chunk < n_reads) gives the single-batch
    decode's mappings, in the port as in the JAX package."""
    def build(S):
        g = small_diploid(S.jax)
        dbg = S.MultiDbg.from_styled_seqs(8, list(g))
        reads = perfect_reads(g, coverage=8, read_len=14, seed=3, jax=S.jax)
        kw = dict(dbg=dbg, params=S.PHMMParams.uniform(0.001), reads=reads,
                  n_active=8)
        return S.gen(read_chunk=0, **kw), S.gen(read_chunk=5, **kw)
    (full, chunked), (ref_full, ref_chunked) = _both(build)
    np.testing.assert_allclose(chunked.read_logps, full.read_logps, atol=1e-9)
    for a, b in zip(chunked.nodes, full.nodes):
        w = min(a.shape[1], b.shape[1])
        assert np.array_equal(a[:, :w], b[:, :w])
        assert (a[:, w:] < 0).all() and (b[:, w:] < 0).all()
    _same_mappings(chunked, ref_chunked)


def test_sample_posterior_recovers_from_corruption_small_graph():
    """The hill climb on the dense decode's mapping, from a corrupted
    neighbour of the truth: back to the truth, with the JAX package's
    samples and likelihoods to 1e-6 relative."""
    def build(S):
        g = small_diploid(S.jax)
        dbg = S.MultiDbg.from_styled_seqs(8, list(g))
        reads = perfect_reads(g, coverage=10, read_len=14, jax=S.jax)
        params = S.PHMMParams.uniform(0.001)
        nb = (jax_neighbors if S.jax else port_neighbors).to_short_neighbors
        work = dbg.copy()
        work.set_copy_nums(nb(dbg, 8, 2)[0][0])
        maps = S.gen(dbg=work, params=params, reads=reads)
        kw = dict(rescue_only=False, max_iter=10)
        if not S.jax:
            kw["device"] = "cpu"
        post = S.P.sample_posterior(work, params, reads, maps,
                                    g.genome_size(), 5, **kw)
        return post, dbg.get_copy_nums()
    (got, true_cn), (ref, _t) = _both(build)
    assert got.max_copy_nums() == ref.max_copy_nums() == true_cn
    _same_samples(got, ref)


def test_sample_posterior_without_mappings_matches_jax():
    """mappings=None: the port scores through candidate_log_likelihoods
    (the dense forward) in sub-batches; the same samples, moves and
    max_copy_nums as the JAX package, likelihoods to 1e-9 relative."""
    def build(S):
        g = small_diploid(S.jax)
        dbg = S.MultiDbg.from_styled_seqs(8, list(g))
        reads = perfect_reads(g, coverage=6, read_len=14, jax=S.jax)
        nb = (jax_neighbors if S.jax else port_neighbors).to_short_neighbors
        work = dbg.copy()
        work.set_copy_nums(nb(dbg, 8, 2)[0][0])
        kw = dict(rescue_only=False, max_iter=2)
        if not S.jax:
            kw["device"] = "cpu"
        return S.P.sample_posterior(work, S.PHMMParams.uniform(0.001), reads,
                                    None, g.genome_size(), 5, **kw)
    got, ref = _both(build)
    assert got.max_copy_nums() == ref.max_copy_nums()
    assert got.max_sample().to_infos_string() == ref.max_sample().to_infos_string()
    _same_samples(got, ref, rtol=1e-9)


@pytest.mark.parametrize("use_hint", [False, True])
def test_infer_small_graph_matches_jax(use_hint):
    """Draft at k=8 -> k=16 on the clean diploid through the from-scratch
    decodes (and, with hints, the refine): both haplotypes assembled, and
    the JAX package's max_copy_nums at every stage
    (tests/test_posterior.py's infer and hint-vs-fresh tests)."""
    def build(S):
        g = small_diploid(S.jax)
        reads = perfect_reads(g, coverage=12, read_len=16, seed=1, jax=S.jax)
        params = S.PHMMParams.uniform(0.001)
        stages = []
        kw = dict(k_max=16, dbg_init=S.MultiDbg.from_styled_seqs(8, list(g)),
                  param_infer=params, param_error=params, reads=reads,
                  genome_size_expected=g.genome_size(), genome_size_sigma=5,
                  max_iter=10, p0=0.8, n_haplotypes=2,
                  use_hint_mappings=use_hint,
                  on_iter=lambda d, p, pa, m: stages.append(
                      (d.k, p.max_copy_nums())))
        if not S.jax:
            kw["device"] = "cpu"
        dbg_final, post, _p, _m = S.P.infer_posterior_by_extension(**kw)
        haps = sorted(s.seq for s, _c in dbg_final.get_linear_haplotype_seqs())
        return dbg_final.k, haps, post.max_copy_nums(), stages, sorted(
            s.seq for s in g)
    got, ref = _both(build)
    assert got[0] == 16 and got[1] == got[4]
    assert got[:4] == ref[:4]


def test_map_and_post_files_round_trip(seeded, tmp_path):
    """The port's readers read back what the shared writers wrote."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, list(g))
    reads = perfect_reads(g, coverage=4, read_len=12)
    params = PHMMParams.uniform(0.001)
    maps = TP.generate_mappings(dbg, params, reads, "cpu")
    TO.to_map_file(dbg, tmp_path / "x.map.mpz", reads, maps)
    back = TO.from_map_file(tmp_path / "x.map.mpz")
    assert back.n_reads() == maps.n_reads()
    for a, b, la, lb in zip(back.nodes, maps.nodes, back.logps, maps.logps):
        w = a.shape[1]
        np.testing.assert_array_equal(a, b[:, :w])
        assert (b[:, w:] < 0).all()
        np.testing.assert_allclose(la[a >= 0], lb[:, :w][a >= 0], rtol=1e-12)

    post = TP.sample_posterior(dbg, params, reads, maps, g.genome_size(), 5,
                               "cpu", rescue_only=False, max_iter=1)
    TO.to_post_file(post, tmp_path / "x.post")
    back_post = TO.from_post_file(tmp_path / "x.post")
    assert isinstance(back_post, TP.Posterior)
    assert len(back_post.samples) == len(post.samples)
    assert back_post.max_copy_nums() == post.max_copy_nums()
    np.testing.assert_allclose(back_post.p, post.p, rtol=1e-12)


@pytest.mark.parametrize("space", ["log", "linear"])
def test_sample_posterior_gives_the_same_moves_in_every_scorer_space(
        seeded, space):
    """The hill climb from a corrupted neighbour of the truth, scored by K2
    ("log") or K3 ("linear", with the rescue) instead of K1 ("packed"):
    the same samples, the same accepted moves, the same max_copy_nums, and
    likelihoods to 1e-6 relative (float64 twins on the CPU)."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, list(g))
    reads = perfect_reads(g, coverage=10, read_len=14)
    params = PHMMParams.uniform(0.001)
    work = dbg.copy()
    work.set_copy_nums(to_short_neighbors(dbg, 8, 2)[0][0])
    mappings = TP.generate_mappings(work, params, reads, "cpu")
    posts = {sp: TP.sample_posterior(work, params, reads, mappings,
                                     g.genome_size(), 5, "cpu",
                                     rescue_only=False, max_iter=10,
                                     scorer_space=sp)
             for sp in ("packed", space)}
    ref, got = posts["packed"], posts[space]
    assert got.max_copy_nums() == ref.max_copy_nums() == dbg.get_copy_nums()
    assert (got.max_sample().to_infos_string()
            == ref.max_sample().to_infos_string())
    assert [s.copy_nums for s in got.samples] == [s.copy_nums for s in ref.samples]
    for s in got.samples:
        np.testing.assert_allclose(s.score.likelihood,
                                   ref.find(s.copy_nums).score.likelihood,
                                   rtol=1e-6)


def _tracking(P, monkeypatch, on_top=None):
    """Wrap ``P.generate_mappings`` (the recursive calls too): returns the
    list of regenerated read indices of each hinted top-level call, found
    by identity among that call's reads.  ``on_top(i, dbg, hint, maps)``
    sees each top-level call's result and may replace it."""
    real = P.generate_mappings
    regen, stack, n_top = [], [], [0]

    def wrapped(dbg, params, reads, *a, **kw):
        hint = kw.get("hint")
        if stack and stack[0] is not None and hint is None:
            outer = stack[0]
            regen[-1].extend(next(i for i, r in enumerate(outer) if r is x)
                             for x in reads)
        if not stack and hint is not None:
            regen.append([])
        stack.append(list(reads) if hint is not None else None)
        try:
            maps = real(dbg, params, reads, *a, **kw)
        finally:
            stack.pop()
        if not stack:
            n_top[0] += 1
            if on_top is not None:
                maps = on_top(n_top[0] - 1, dbg, hint, maps)
        return maps

    monkeypatch.setattr(P, "generate_mappings", wrapped)
    return regen


def _infer_both(monkeypatch, capsys, patch, k_max=16):
    """The small diploid, draft at k=8 -> ``k_max`` with hint mappings, in
    both packages; ``patch(S)`` monkeypatches side S before its run.
    Returns {side: (max_copy_nums per stage, exact, output, patch's
    result)}."""
    def build(S):
        g = small_diploid(S.jax)
        reads = perfect_reads(g, coverage=12, read_len=16, seed=1, jax=S.jax)
        params = S.PHMMParams.uniform(0.001)
        extra = patch(S)
        stages = []
        kw = dict(k_max=k_max, dbg_init=S.MultiDbg.from_styled_seqs(8, list(g)),
                  param_infer=params, param_error=params, reads=reads,
                  genome_size_expected=g.genome_size(), genome_size_sigma=5,
                  max_iter=10, p0=0.8, n_haplotypes=2, use_hint_mappings=True,
                  verbose=True,
                  on_iter=lambda d, p, pa, m: stages.append(
                      (d.k, p.max_copy_nums())))
        if not S.jax:
            kw["device"] = "cpu"
        capsys.readouterr()
        dbg_final, _post, _p, _m = S.P.infer_posterior_by_extension(**kw)
        out = capsys.readouterr().out
        monkeypatch.undo()
        haps = sorted(s.seq for s, _c in dbg_final.get_linear_haplotype_seqs())
        return stages, haps == sorted(s.seq for s in g), out, extra
    got, ref = _both(build)
    return {"torch": got, "jax": ref}


def test_hint_gate_regenerates_the_same_reads_as_jax(monkeypatch, capsys):
    """tests/test_posterior.py's hint-gate test in both packages: the
    upconverted hints of every other read are zeroed (node 0 everywhere),
    so the acceptance gate fires and regenerates those reads from scratch.
    Both packages regenerate the same reads at every stage, reach the same
    max_copy_nums at every stage, and assemble both haplotypes exactly."""
    def patch(S):
        real_pe = S.P.purge_and_extend_with_posterior
        n_scrambled = [0]

        def scrambling_pe(*args, **kwargs):
            dbg_k, paths, maps2 = real_pe(*args, **kwargs)
            if maps2 is not None:
                for r in range(0, len(maps2), 2):
                    if maps2[r].size:
                        maps2[r][:] = 0
                        n_scrambled[0] += 1
            return dbg_k, paths, maps2

        monkeypatch.setattr(S.P, "purge_and_extend_with_posterior",
                            scrambling_pe)
        return n_scrambled, _tracking(S.P, monkeypatch)

    res = _infer_both(monkeypatch, capsys, patch)
    for side, (stages, exact, out, (n_scrambled, regen)) in res.items():
        assert n_scrambled[0] > 0, side
        assert "hint gate: regenerating" in out, (side, out[-2000:])
        assert any(regen), side
        assert exact, side
    assert res["torch"][3][1] == res["jax"][3][1]
    assert res["torch"][0] == res["jax"][0]


def test_blown_up_mapping_freqs_are_regenerated_from_scratch(monkeypatch,
                                                             capsys):
    """The guard after each stage's mapping: the first refined mapping
    (the first extension's, k=8 -> 10) is handed back with a node freq above ``mass_cap_total()``; both
    packages print the blown-up line and decode that stage from scratch.
    The regenerated mapping equals a from-scratch ``generate_mappings`` of
    the same stage, the port's equals the JAX package's, and both reach the
    same max_copy_nums at every stage and an exact assembly."""
    def patch(S):
        seen = {}

        def on_top(i, dbg, hint, maps):
            if hint is not None and "blown" not in seen:
                freqs = maps.to_node_freqs
                blow = np.zeros(dbg.n_edges_full())
                blow[0] = 10 * maps.mass_cap_total()
                maps.to_node_freqs = lambda n: freqs(n) + blow[:n]
                seen["blown"] = i
            elif i == seen.get("blown", -2) + 1:
                seen.update(dbg=dbg.copy(), maps=maps)
            return maps

        _tracking(S.P, monkeypatch, on_top)
        return seen

    res = _infer_both(monkeypatch, capsys, patch, k_max=10)
    regenerated = {}
    for side, (stages, exact, out, seen) in res.items():
        assert "[infer] mapping freqs blown up" in out, (side, out[-2000:])
        assert seen["blown"] == 1, side  # the first extension's refine
        assert seen["dbg"].k == stages[1][0] == 10, side
        assert exact, side
        maps = seen["maps"]
        assert maps.stages_since_anchor == 0, side  # from scratch
        S = SimpleNamespace(jax=side == "jax")
        params = (jax_params if S.jax else port_params).PHMMParams.uniform(0.001)
        reads = perfect_reads(small_diploid(S.jax), coverage=12, read_len=16,
                              seed=1, jax=S.jax)
        fresh = (JP.generate_mappings(seen["dbg"], params, reads) if S.jax
                 else TP.generate_mappings(seen["dbg"], params, reads, "cpu"))
        _same_mappings(maps, fresh)
        regenerated[side] = maps
    _same_mappings(regenerated["torch"], regenerated["jax"])
    assert res["torch"][0] == res["jax"][0]
