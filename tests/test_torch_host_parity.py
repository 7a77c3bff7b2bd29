"""The port's own copies of the host layers (graphs, drafting, flow,
seeding, neighbours, Euler counts, the PHMM template, read simulation and
file formats) against the JAX package's originals.

Each side builds its own objects from the same seeded inputs with its own
modules; the results must be equal (arrays and text exactly, floats to
1e-12 relative), and each side must read the files the other wrote.
"""

import gzip
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = ("seq.genome", "seq.collection", "e2e", "multi_dbg",
           "multi_dbg.draft", "multi_dbg.neighbors", "multi_dbg.seed",
           "multi_dbg.output", "multi_dbg.posterior", "graph.euler",
           "phmm.params", "phmm.template")

# (name, genome arguments of tandem_repeat_polyploid_with_unique_homo_ends,
#  k of the graph, read seed, coverage, read length)
CASES = {
    "tandem_50x4": ((50, 4, 0, 0.02, 0, 100, 2, 0.01, 0), 16, 0, 6, 200),
    "tandem_20x10": ((20, 10, 0, 0.0, 0, 50, 2, 0.02, 3), 12, 1, 8, 120),
}


def side(pkg):
    """The modules of one package, by their relative names."""
    return SimpleNamespace(**{
        m.replace(".", "_"): importlib.import_module(f"{pkg}.{m}")
        for m in MODULES})


JAX, PORT = side("dbgphmm_tpu"), side("dbgphmm_tpu_torch")


def build(S, case):
    g_args, k, read_seed, coverage, read_len = CASES[case]
    g = S.seq_genome.tandem_repeat_polyploid_with_unique_homo_ends(*g_args)
    params = S.phmm_params.PHMMParams.uniform(0.01)
    ds = S.e2e.generate_dataset(g, read_seed, coverage, read_len,
                                S.e2e.ReadType.FIXED_SIZE_FRAGMENT, params)
    dbg = S.multi_dbg.MultiDbg.from_styled_seqs(k, list(g))
    return SimpleNamespace(genome=g, params=params, ds=ds, dbg=dbg,
                           reads=list(ds.reads))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return build(JAX, request.param), build(PORT, request.param)


def _neighbours(S, dbg):
    return [(list(cn), str(info)) for cn, info in
            S.multi_dbg_neighbors.to_neighbor_copy_nums_and_infos(
                dbg, S.multi_dbg_neighbors.NeighborConfig())]


def _with_a_zero_edge(S, dbg):
    """A copy of ``dbg`` moved to its first short neighbour that zeroes a
    compact edge (so that rescue neighbours exist)."""
    work = dbg.copy()
    cn = next(cn for cn, _i in S.multi_dbg_neighbors.to_short_neighbors(dbg, 8, 2)
              if 0 in cn)
    work.set_copy_nums(cn)
    return work


def test_dataset_reads_match_jax(pair):
    """e2e dataset generation: the same reads from one seed, and the same
    dataset JSON."""
    j, t = pair
    assert [bytes(r) for r in t.reads] == [bytes(r) for r in j.reads]
    assert len(t.reads) > 5
    assert t.ds.to_json() == j.ds.to_json()


def test_draft_from_reads_matches_jax(pair):
    """HashDbg, dead-end cleaning and the flow solver's MSE copy numbers:
    the same compact graph and copy numbers, as equal .dbg text."""
    j, t = pair
    drafts = [S.multi_dbg_draft.create_draft_from_dataset(
        d.dbg.k, d.ds, min_deadend_count=1) for S, d in ((JAX, j), (PORT, t))]
    texts = [S.multi_dbg_output.to_dbg_string(dr)
             for S, dr in zip((JAX, PORT), drafts)]
    assert drafts[1].n_edges_compact() > 1
    assert texts[1] == texts[0]


def test_graph_and_template_match_jax(pair):
    """MultiDbg from the genome (equal .dbg text) and make_template: every
    array equal, and equal per-candidate models."""
    j, t = pair
    assert (PORT.multi_dbg_output.to_dbg_string(t.dbg)
            == JAX.multi_dbg_output.to_dbg_string(j.dbg))
    tj = JAX.phmm_template.make_template(j.dbg, j.params)
    tt = PORT.phmm_template.make_template(t.dbg, t.params)
    for f in ("emission", "emittable", "src_node", "full_to_compact",
              "parent_idx", "parent_exists", "child_idx", "child_exists"):
        a, b = getattr(tt, f), getattr(tj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tt.n_nodes_graph == tj.n_nodes_graph
    for cn, _i in JAX.multi_dbg_neighbors.to_short_neighbors(j.dbg, 8, 2)[:3]:
        mj, mt = tj.model_for(cn), tt.model_for(cn)
        for f in ("emission", "init_logp", "parent_idx", "parent_logt"):
            np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f),
                                          err_msg=f)


def test_seed_mappings_and_neighbours_match_jax(pair):
    """seed_mappings_arrays, the full and the rescue neighbourhoods."""
    j, t = pair
    sj = JAX.multi_dbg_seed.seed_mappings_arrays(j.dbg, j.reads)
    st = PORT.multi_dbg_seed.seed_mappings_arrays(t.dbg, t.reads)
    assert len(st) == len(sj)
    for a, b in zip(st, sj):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert _neighbours(PORT, t.dbg) == _neighbours(JAX, j.dbg)
    freqs = np.random.default_rng(5).uniform(0, 20, j.dbg.n_edges_full())
    res = []
    for S, d in ((JAX, j), (PORT, t)):
        work = _with_a_zero_edge(S, d.dbg)
        res.append([(list(cn), str(i)) for cn, i in
                    S.multi_dbg_neighbors.to_rescue_neighbors(
                        work, list(freqs), 6.0)])
    assert res[1] == res[0] and len(res[0]) > 0


def test_euler_counts_and_mse_copy_numbers_match_jax(pair):
    """EulerCache counts of the neighbourhood and the MSE copy numbers from
    node frequencies (the native flow solver)."""
    j, t = pair
    cands = [cn for cn, _i in
             JAX.multi_dbg_neighbors.to_short_neighbors(j.dbg, 8, 2)]
    counts = []
    for S, d in ((JAX, j), (PORT, t)):
        cache = S.graph_euler.EulerCache(d.dbg.compact, d.dbg.get_copy_nums())
        counts.append([cache.count(cn) for cn in cands])
    np.testing.assert_allclose(counts[1], counts[0], rtol=1e-12, atol=0)
    freqs = np.random.default_rng(7).uniform(0, 12, j.dbg.n_edges_full())
    mse = [S.multi_dbg_draft.min_squared_error_copy_nums_from_freqs(
        d.dbg, list(freqs), 5.0, 2) for S, d in ((JAX, j), (PORT, t))]
    assert mse[1] == mse[0]


def _post(S, cands):
    """A posterior over ``cands`` with fixed scores, in one package's types."""
    P = S.multi_dbg_posterior
    post = P.Posterior()
    for i, cn in enumerate(cands):
        post.add(P.PosteriorSample(list(cn), P.Score(
            -100.0 - 3.5 * i, -0.25 * i, 100 + i, 1.5 + i)))
    return post


def test_files_match_jax_and_read_across(pair, tmp_path):
    """.dbg, .map.mpz and .post written by each package are equal (the
    .map.mpz after gunzip: the gzip header holds the write time), and each
    package reads the other's files back to the same objects."""
    j, t = pair
    seeds = JAX.multi_dbg_seed.seed_mappings_arrays(j.dbg, j.reads)
    rng = np.random.default_rng(11)
    logps = [np.where(a >= 0, -rng.exponential(1.0, a.shape), -np.inf)
             for a in seeds]
    cands = [cn for cn, _i in
             JAX.multi_dbg_neighbors.to_short_neighbors(j.dbg, 8, 2)[:4]]
    paths = {}
    for name, S, d in (("jax", JAX, j), ("port", PORT, t)):
        O = S.multi_dbg_output
        p = {ext: tmp_path / f"{name}.{ext}" for ext in ("dbg", "map.mpz", "post")}
        O.to_dbg_file(d.dbg, p["dbg"])
        maps = S.multi_dbg_posterior.Mappings([a.copy() for a in seeds],
                                              [a.copy() for a in logps])
        O.to_map_file(d.dbg, p["map.mpz"], d.reads, maps)
        O.to_post_file(_post(S, cands), p["post"])
        paths[name] = p
    for ext in ("dbg", "post"):
        assert paths["port"][ext].read_bytes() == paths["jax"][ext].read_bytes()
    unzip = lambda q: gzip.decompress(q.read_bytes())
    assert unzip(paths["port"]["map.mpz"]) == unzip(paths["jax"]["map.mpz"])

    # each side reads the other's files
    for S, other in ((PORT, "jax"), (JAX, "port")):
        O = S.multi_dbg_output
        dbg = O.from_dbg_file(paths[other]["dbg"])
        assert O.to_dbg_string(dbg) == paths[other]["dbg"].read_text()
        maps = O.from_map_file(paths[other]["map.mpz"])
        assert maps.n_reads() == len(seeds)
        for a, la, b, lb in zip(maps.nodes, maps.logps, seeds, logps):
            w = a.shape[1]
            np.testing.assert_array_equal(a, b[:, :w])
            assert (b[:, w:] < 0).all()
            np.testing.assert_allclose(la[a >= 0], lb[:, :w][a >= 0],
                                       rtol=1e-12)
        post = O.from_post_file(paths[other]["post"])
        ref = _post(S, cands)
        assert [s.copy_nums for s in post.samples] == [
            s.copy_nums for s in sorted(ref.samples, key=lambda s: -s.score.p())]
        for s in post.samples:
            assert s.score.to_json() == ref.find(s.copy_nums).score.to_json()
