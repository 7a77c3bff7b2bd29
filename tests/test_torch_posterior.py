"""The port's posterior inference (dbgphmm_tpu_torch.multi_dbg.posterior)
against the JAX package on the small diploid of tests/test_posterior.py.

Both packages are pushed onto the seeded regime by setting
DENSE_COMPUTE_MAX_NODES to 0 in each (monkeypatch; no file of the JAX
package changes), so the JAX reference runs the same path as the port:
seeding + refine, mapped candidate scoring (float64 XLA there, the K1
kernel's float64 twin here), hill climb, purge and extension.
"""

import numpy as np
import pytest

import dbgphmm_tpu.multi_dbg.posterior as JP
import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu.seq.genome import Genome
from dbgphmm_tpu_torch.multi_dbg import output as TO


def small_diploid():
    h1 = b"TTAGGCTTCGATCGAATGCC"
    h2 = b"TTAGGCTTGGATCGAATGCC"
    return Genome([StyledSequence.linear(h1), StyledSequence.linear(h2)])


def perfect_reads(genome, coverage=10, read_len=12, seed=0):
    rng = np.random.default_rng(seed)
    reads = []
    for s in genome:
        n = int(len(s.seq) * coverage / read_len)
        for _ in range(n):
            st = rng.integers(0, len(s.seq) - read_len + 1)
            reads.append(s.seq[st : st + read_len])
    return ReadCollection(reads)


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
    g = small_diploid()
    reads = perfect_reads(g, coverage=12, read_len=16, seed=1)
    params = PHMMParams.uniform(0.001)
    draft = MultiDbg.from_styled_seqs(8, list(g))
    assert draft.get_copy_nums() == [2, 1, 1, 2]
    draft.set_copy_nums([1, 0, 1, 1])  # a +-1 cycle away from the truth
    results = {}
    for name, run in (
        ("jax", lambda **kw: JP.infer_posterior_by_extension(**kw)),
        ("torch", lambda **kw: TP.infer_posterior_by_extension(device="cpu", **kw)),
    ):
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


def test_small_graph_without_hint_is_not_routed_elsewhere():
    """Below DENSE_COMPUTE_MAX_NODES the from-scratch decode is not ported:
    the call raises and names the ROADMAP items that port it."""
    g = small_diploid()
    dbg = MultiDbg.from_styled_seqs(8, list(g))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TP.generate_mappings(dbg, PHMMParams.uniform(0.001),
                             perfect_reads(g), "cpu")


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
