"""The port's scale-out (dbgphmm_tpu_torch.parallel and the mesh= paths)
against itself unsharded and against the JAX package: the counterparts of
tests/test_parallel.py, on meshes of 8 copies of the CPU in the shapes the
JAX tests use over conftest's 8 virtual devices.

The port's sharded results are held to its unsharded ones (float64: totals
within 1e-9 absolute, node tables equal, ok flags equal) and to the JAX
package's on the same numpy inputs: within 1e-9 on the float64 dense and
mapped paths; for the scorer, whose JAX side is the float32 Pallas kernel
in interpret mode, per read within 1e-5 |ref| + 0.05 nats with the same
best candidate.  tests/test_parallel.py already holds the JAX scorer
sharded equal to unsharded, so its unsharded call is the reference there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dbgphmm_tpu.multi_dbg.posterior as JP
import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu import multi_dbg as jax_multi_dbg
from dbgphmm_tpu import parallel as JPar
from dbgphmm_tpu.ops import forward as JF
from dbgphmm_tpu.ops import pallas_mapped as J
from dbgphmm_tpu.ops import sparse as JS
from dbgphmm_tpu.ops.batch import candidate_log_likelihoods as jax_cll
from dbgphmm_tpu.phmm import model as jax_model
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.phmm import template as jax_template
from dbgphmm_tpu.seq import collection as jax_collection
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch import parallel as P
from dbgphmm_tpu_torch.ops import forward as TF
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops import sparse as TS
from dbgphmm_tpu_torch.ops.batch import candidate_log_likelihoods
from dbgphmm_tpu_torch.phmm import model as port_model
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.phmm import template as port_template
from dbgphmm_tpu_torch.seq import collection as port_collection

from test_torch_posterior import one_torch_thread  # noqa: F401
from test_torch_scorer_spaces import long_bubble  # noqa: F401

SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]  # (cand, reads)
REL_TOL, ABS_TOL = 1e-5, 0.05  # per read, float64 twin vs float32 Pallas


def cpu_mesh(shape):
    return P.make_mesh(shape[0] * shape[1], cand_axis=shape[0], device="cpu")


def jax_mesh(shape):
    return JPar.make_mesh(shape[0] * shape[1], cand_axis=shape[0])


@pytest.fixture(scope="module")
def linear():
    """tests/test_parallel.py's linear model and its 10 reads."""
    assert len(jax.devices()) >= 8, "needs 8 virtual devices (conftest)"
    seq = b"ATTCGATCGTACGGTTAACG" * 3
    reads = [seq[i:i + 30] for i in range(0, 30, 3)]
    dm = TF.to_device(port_model.linear_phmm(
        seq, port_params.PHMMParams.default()), "cpu", torch.float64)
    dm_j = JF.to_device(jax_model.linear_phmm(
        seq, jax_params.PHMMParams.default()), dtype=jnp.float64)
    codes, lens = TF.pad_reads(reads)
    return dm, dm_j, codes, lens


def _local_total(dm, codes, lens):
    return float(TF.forward_scores(dm, torch.as_tensor(codes),
                                   torch.as_tensor(lens)).sum())


def _jax_total(dm_j, codes, lens):
    return float(jnp.sum(JF.forward_scores(dm_j, jnp.asarray(codes),
                                           jnp.asarray(lens), renorm=True)))


@pytest.mark.parametrize("shape", SHAPES + [(1, 4), (2, 2)])
def test_sharded_total_matches_local(linear, shape):
    dm, dm_j, codes, lens = linear
    total = P.sharded_forward_total(dm, codes, lens, cpu_mesh(shape))
    local = _local_total(dm, codes, lens)
    assert total == pytest.approx(local, abs=1e-9)
    ref = JPar.sharded_forward_total(dm_j, codes, lens, jax_mesh(shape))
    assert total == pytest.approx(ref, abs=1e-9)


def test_uneven_read_count_padding(linear):
    """10 reads on an 8-way mesh: two shards hold a padding read each."""
    dm, dm_j, codes, lens = linear
    total = P.sharded_forward_total(dm, codes, lens, cpu_mesh((1, 8)))
    assert total == pytest.approx(_local_total(dm, codes, lens), abs=1e-9)
    assert total == pytest.approx(_jax_total(dm_j, codes, lens), abs=1e-9)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
def test_sharded_candidates_match_local(linear, shape):
    """Five candidates (not a multiple of the cand axis) with scaled init
    probabilities, against each one's local total and the JAX sharded
    call on the same mesh shape."""
    dm, dm_j, codes, lens = linear
    scales = (1.0, 0.5, 0.25, 0.125, 0.0625)
    dms = [dataclasses.replace(dm, init_logp=dm.init_logp + np.log(s))
           for s in scales]
    lls = P.sharded_candidate_log_likelihoods(dms, codes, lens, cpu_mesh(shape))
    assert lls.shape == (5,)
    for ll, d in zip(lls, dms):
        assert ll == pytest.approx(_local_total(d, codes, lens), abs=1e-9)
    dms_j = [dataclasses.replace(dm_j, init_logp=dm_j.init_logp + jnp.log(s))
             for s in scales]
    ref = JPar.sharded_candidate_log_likelihoods(dms_j, codes, lens,
                                                 jax_mesh(shape))
    np.testing.assert_allclose(lls, ref, rtol=0, atol=1e-9)
    n = codes.shape[0]
    assert lls[1] - lls[0] == pytest.approx(n * np.log(0.5), abs=1e-6)


# -- the production inputs: a small diploid DBG, reads and mappings ----------


H1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGATTCAAGGC"
H2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGATTCAAGGC"
# tests/test_parallel.py's six reads and five more: 11 reads, so that the
# scorer's read blocks (8 R reads per chunk) and the decodes' flat blocks
# come out uneven
READ_SLICES = [(0, 1, 30), (1, 3, 33), (0, 0, 25), (1, 10, 38), (0, 5, 35),
               (1, 0, 20), (0, 8, 36), (1, 2, 29), (0, 12, 38), (1, 6, 31),
               (0, 3, 27)]


def _dbg(mod, col):
    return mod.MultiDbg.from_styled_seqs(
        8, [col.StyledSequence.linear(H1), col.StyledSequence.linear(H2)])


def _reads(col):
    return col.ReadCollection([(H1, H2)[h][a:b] for h, a, b in READ_SLICES])


def _candidates(base):
    """The base copy numbers and +1 on each compact edge: 5 candidates."""
    cands = [list(base)]
    for e in range(len(base)):
        up = list(base)
        up[e] += 1
        cands.append(up)
    return cands


@pytest.fixture(scope="module")
def dbg_setup():
    """Both packages' graph, reads and params; the port's mapping, padded
    into one map_nodes array that both packages' positions come from."""
    dbg = _dbg(port_multi_dbg, port_collection)
    reads = _reads(port_collection)
    params = port_params.PHMMParams.uniform(0.001)
    mappings = TP.generate_mappings(dbg, params, reads, "cpu")
    codes, lens = TF.pad_reads(list(reads))
    width = max(n.shape[1] for n in mappings.nodes)
    map_nodes = TS.pad_mappings(mappings, codes.shape[1], width)
    tpl = port_template.make_template(dbg, params)
    pos = TS.precompute_positions(map_nodes, tpl.parent_idx,
                                  parent_exists=tpl.parent_exists)
    dbg_j = _dbg(jax_multi_dbg, jax_collection)
    params_j = jax_params.PHMMParams.uniform(0.001)
    tpl_j = jax_template.make_template(dbg_j, params_j)
    pos_j = JS.precompute_positions(map_nodes, tpl_j.parent_idx,
                                    parent_exists=tpl_j.parent_exists)
    return dict(dbg=dbg, reads=reads, params=params, mappings=mappings,
                codes=codes, lens=lens, map_nodes=map_nodes, tpl=tpl, pos=pos,
                dbg_j=dbg_j, reads_j=_reads(jax_collection),
                params_j=params_j, tpl_j=tpl_j, pos_j=pos_j,
                cands=_candidates(dbg.get_copy_nums()))


@pytest.mark.parametrize("branch", ["positions", "map_nodes", "dense"])
def test_sharded_mapped_candidates_match_local(dbg_setup, branch):
    """candidate_log_likelihoods (the batch scorer) sharded over each mesh
    shape equals the port's unsharded call and the JAX call with the same
    branch (its positions branch looks the slots up; the values are the
    same), float64."""
    S = dbg_setup
    kw = {"positions": dict(positions=S["pos"]),
          "map_nodes": dict(map_nodes=S["map_nodes"]), "dense": {}}[branch]
    kw_j = {"positions": dict(positions=S["pos_j"]),
            "map_nodes": dict(map_nodes=S["map_nodes"]), "dense": {}}[branch]
    models = [S["tpl"].model_for(cn) for cn in S["cands"]]
    local = candidate_log_likelihoods(models, S["codes"], S["lens"], "cpu", **kw)
    assert len(set(np.round(local, 6))) > 1, "candidates must be distinct"
    models_j = [S["tpl_j"].model_for(cn) for cn in S["cands"]]
    ref = jax_cll(models_j, S["codes"], S["lens"], dtype=jnp.float64, **kw_j)
    np.testing.assert_allclose(local, ref, rtol=0, atol=1e-9)
    for shape in SHAPES:
        sharded = candidate_log_likelihoods(models, S["codes"], S["lens"],
                                            "cpu", mesh=cpu_mesh(shape), **kw)
        np.testing.assert_allclose(sharded, local, rtol=0, atol=1e-9)
    if branch != "positions":  # tests/test_parallel.py holds that one
        ref_sharded = jax_cll(models_j, S["codes"], S["lens"],
                              dtype=jnp.float64, mesh=jax_mesh((2, 4)), **kw_j)
        np.testing.assert_allclose(ref_sharded, ref, rtol=0, atol=1e-9)


def _jax_per_read(scorer_j, cands, order):
    """The JAX scorer's [C, B] per-read scores in the original read order
    (it sorts the reads as the port's scorer does, by ``order``)."""
    got = np.asarray(scorer_j._scores_all_chunks(list(cands)))[
        :len(cands), :scorer_j.n_reads].astype(np.float64)
    out = np.empty_like(got)
    out[:, order] = got
    return out


def _scorer_case(S, space):
    """The port's scorer sharded over every mesh shape against its
    unsharded scorer (per read to 1e-9, the same ok flags; one launch per
    shard with reads and candidates), and the unsharded scorer against
    the JAX Pallas scorer in interpret mode (the scorer gate)."""
    cands = S["cands"] + [[0] * len(S["cands"][0])]  # last: every read -inf
    mk = lambda mesh=None: T.MappedScorer(S["tpl"], S["pos"], S["codes"],
                                          S["lens"], S["params"], "cpu",
                                          space=space, mesh=mesh)
    local = mk()
    per_l = local.per_read(cands)
    tot_l, ok_l = local.scores_detailed(cands)
    assert not ok_l[-1] and ok_l[:-1].all()
    fin = np.isfinite(per_l)
    twin = {"packed": T.mapped_scores_log_reference,
            "log": T.mapped_scores_log_single_reference,
            "linear": T.mapped_scores_linear_reference}[space]
    for shape in SHAPES:
        mesh = cpu_mesh(shape)
        sharded = mk(mesh)
        n0 = twin.calls
        per_s = sharded.per_read(cands)
        # one launch per shard whose block holds reads and real candidates
        n_cs, n_rs = shape
        per = -(-len(cands) // n_cs)
        rows = [min(len(cands), (g + 1) * per) - g * per for g in range(n_cs)]
        n_blocks = sum(1 for b in sharded.blocks if b[3])
        assert twin.calls - n0 == n_blocks * sum(r > 0 for r in rows), shape
        assert n_blocks == min(n_rs, -(-len(S["reads"]) // 8)), sharded.blocks
        np.testing.assert_array_equal(np.isfinite(per_s), fin)
        np.testing.assert_allclose(per_s[fin], per_l[fin], rtol=0, atol=1e-9)
        tot_s, ok_s = sharded.scores_detailed(cands)
        np.testing.assert_array_equal(ok_s, ok_l)
        np.testing.assert_allclose(tot_s[ok_l], tot_l[ok_l], rtol=0, atol=1e-9)
    return cands, local, per_l


def _hold_to_pallas(S, space, cands, local, per_l):
    scorer_j = J.PallasMappedScorer(S["tpl_j"], S["pos_j"], S["codes"],
                                    S["lens"], S["tpl_j"].params, space=space)
    assert scorer_j.interpret
    ref = _jax_per_read(scorer_j, cands[:-1], local.order)
    got = per_l[:-1]
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin])
    assert (err <= REL_TOL * np.abs(ref[fin]) + ABS_TOL).all(), err.max()
    assert int(got.sum(1).argmax()) == int(ref.sum(1).argmax())


def test_sharded_pallas_scorer_matches_local(dbg_setup):
    """MappedScorer(space="log"), K2's float64 twin, sharded against local
    and against the JAX Pallas log scorer; the linear space (K3's twin)
    sharded against local as well."""
    _hold_to_pallas(dbg_setup, "log", *_scorer_case(dbg_setup, "log"))
    _scorer_case(dbg_setup, "linear")


def test_sharded_packed_scorer_matches_local(dbg_setup):
    """MappedScorer(space="packed"), K1's float64 twin, sharded against
    local and against the JAX packed Pallas scorer."""
    _hold_to_pallas(dbg_setup, "packed", *_scorer_case(dbg_setup, "packed"))


def test_sharded_rescue_and_log_sibling(long_bubble):
    """score_candidates with a linear scorer sharded over a 2x2 mesh: the
    candidates K3's twin flags are rescored by the log sibling, which
    shares the shards' streams; every score and the rescue count equal the
    unsharded scorer's, and a scorer built on another mesh is refused."""
    dbg, tpl, pos, codes, lens, cands = long_bubble
    mesh = cpu_mesh((2, 2))
    lin = TP.make_scorer(tpl, pos, codes, lens, tpl.params, "cpu",
                         space="linear", mesh=mesh)
    sib = lin.log_sibling()
    assert sib._dev is lin._dev and sib.mesh is mesh and sib.space == "log"
    runs = {}
    for name, scorer, m in (("mesh", lin, mesh), ("local", TP.make_scorer(
            tpl, pos, codes, lens, tpl.params, "cpu", space="linear"), None)):
        times = TP.StageTimes(k=dbg.k)
        scores = TP.score_candidates(dbg, cands, 400, 10, scorer, times, mesh=m)
        runs[name] = ([s.likelihood for s in scores], times.n_rescued)
    assert 0 < runs["mesh"][1] == runs["local"][1] < len(cands)
    np.testing.assert_allclose(runs["mesh"][0], runs["local"][0], rtol=0,
                               atol=1e-9)
    with pytest.raises(ValueError, match="another mesh"):
        TP.score_candidates(dbg, cands, 400, 10, lin, mesh=cpu_mesh((2, 2)))


def _posteriors_equal(got, ref, atol):
    assert got.max_copy_nums() == ref.max_copy_nums()
    a = {tuple(s.copy_nums): s.score for s in got.samples}
    b = {tuple(s.copy_nums): s.score for s in ref.samples}
    assert set(a) == set(b)
    for key in a:
        assert a[key].likelihood == pytest.approx(b[key].likelihood, abs=atol)
        assert a[key].p() == pytest.approx(b[key].p(), abs=atol)


@pytest.mark.parametrize("with_mappings", [True, False])
def test_sharded_sample_posterior_matches_local(dbg_setup, with_mappings):
    """One production inference step from the perturbed copy numbers
    [2, 2, 0, 2] (rescue neighbours, scoring — mapped through MappedScorer,
    or dense through BatchScorer without mappings — and the multi-move) on
    a 2x4 mesh equals the local run and the JAX package's sharded run on
    the same mesh shape: the same samples, the same argmax, likelihoods and
    posteriors to 1e-9."""
    S = dbg_setup
    G = S["dbg"].genome_size()
    dbg, dbg_j = S["dbg"].copy(), S["dbg_j"].copy()
    dbg.set_copy_nums([2, 2, 0, 2])
    dbg_j.set_copy_nums([2, 2, 0, 2])
    maps = maps_j = None
    if with_mappings:
        maps = TP.generate_mappings(dbg, S["params"], S["reads"], "cpu")
        maps_j = JP.Mappings([a.copy() for a in maps.nodes],
                             [a.copy() for a in maps.logps])
    local = TP.sample_posterior(dbg, S["params"], S["reads"], maps, G, 100,
                                "cpu", max_iter=3)
    sharded = TP.sample_posterior(dbg, S["params"], S["reads"], maps, G, 100,
                                  "cpu", max_iter=3, mesh=cpu_mesh((2, 4)))
    assert len(sharded.samples) > 1
    assert sharded.max_copy_nums() == [2, 1, 1, 2]
    _posteriors_equal(sharded, local, 1e-9)
    ref = JP.sample_posterior(dbg_j, S["params_j"], S["reads_j"], maps_j, G,
                              100, max_iter=3, mesh=jax_mesh((2, 4)))
    _posteriors_equal(sharded, ref, 1e-9)


def _nodes_equal(a_maps, b_maps):
    assert a_maps.n_reads() == b_maps.n_reads()
    for a, b in zip(a_maps.nodes, b_maps.nodes):
        w = min(a.shape[1], b.shape[1])
        np.testing.assert_array_equal(a[:, :w], b[:, :w])
        assert (a[:, w:] < 0).all() and (b[:, w:] < 0).all()


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_generate_mappings_matches_local(dbg_setup, shape):
    """The from-scratch dense decode with the reads flat over every mesh
    device (11 reads over 8: uneven blocks, one of padding only) equals the
    local decode and the JAX decode, node for node."""
    S = dbg_setup
    sharded = TP.generate_mappings(S["dbg"], S["params"], S["reads"], "cpu",
                                   mesh=cpu_mesh(shape))
    _nodes_equal(sharded, S["mappings"])
    np.testing.assert_allclose(sharded.read_logps, S["mappings"].read_logps,
                               rtol=0, atol=1e-9)
    ref = JP.generate_mappings(S["dbg_j"], S["params_j"], S["reads_j"],
                               mesh=jax_mesh(shape))
    _nodes_equal(sharded, ref)
    np.testing.assert_allclose(sharded.read_logps, ref.read_logps, rtol=0,
                               atol=1e-9)


def test_sharded_generate_mappings_with_hint_matches_local(dbg_setup):
    """Hint-seeded regeneration (mappings_refine, the seeded path's decode)
    under a mesh matches the local hint run and the JAX hint run read for
    read."""
    S = dbg_setup
    local = TP.generate_mappings(S["dbg"], S["params"], S["reads"], "cpu",
                                 hint=S["mappings"])
    sharded = TP.generate_mappings(S["dbg"], S["params"], S["reads"], "cpu",
                                   hint=S["mappings"], mesh=cpu_mesh((2, 4)))
    _nodes_equal(sharded, local)
    np.testing.assert_allclose(sharded.read_logps, local.read_logps, rtol=0,
                               atol=1e-9)
    hint_j = JP.Mappings([a.copy() for a in S["mappings"].nodes],
                         [a.copy() for a in S["mappings"].logps],
                         S["mappings"].read_logps.copy(),
                         S["mappings"].anchor_logps.copy())
    ref = JP.generate_mappings(S["dbg_j"], S["params_j"], S["reads_j"],
                               hint=hint_j, mesh=jax_mesh((2, 4)))
    _nodes_equal(sharded, ref)
    np.testing.assert_allclose(sharded.read_logps, ref.read_logps, rtol=0,
                               atol=1e-9)


def test_infer_by_extension_with_a_mesh_matches_local(dbg_setup):
    """infer_posterior_by_extension(mesh=) from k=8 to 9, from a draft one
    +-1 cycle off the truth: the same stages and final copy numbers as
    without a mesh."""
    S = dbg_setup
    runs = {}
    for name, mesh in (("local", None), ("mesh", cpu_mesh((2, 4)))):
        draft = S["dbg"].copy()
        draft.set_copy_nums([2, 2, 0, 2])
        stages = []
        dbg_f, post, _paths, _maps = TP.infer_posterior_by_extension(
            9, draft, S["params"], S["params"], S["reads"],
            S["dbg"].genome_size(), 10, "cpu", max_iter=5, mesh=mesh,
            on_iter=lambda d, p, pa, m: stages.append((d.k, p.max_copy_nums())))
        runs[name] = (stages, dbg_f.get_copy_nums(), post)
    assert runs["mesh"][0] == runs["local"][0]
    assert [k for k, _ in runs["mesh"][0]] == [8, 9]
    assert runs["mesh"][1] == runs["local"][1]
    _posteriors_equal(runs["mesh"][2], runs["local"][2], 1e-9)


# -- meshes ------------------------------------------------------------------


def test_make_mesh_and_its_helpers():
    """Mesh shapes and axes as the JAX callers read them; a mesh of more
    CUDA devices than are visible is an error; repeated devices get one
    copy of a replicated array; read blocks go to the shards in mesh
    order."""
    mesh = cpu_mesh((2, 4))
    assert mesh.shape == {"cand": 2, "reads": 4} and mesh.size == 8
    assert mesh.axis_names == ("cand", "reads") and not mesh.is_global
    assert P.mesh_read_axis_size(mesh) == 4
    assert P.mesh_read_axis_size(mesh, flat=True) == 8
    with pytest.raises(ValueError, match="CUDA devices"):
        P.make_mesh(torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="candidate rows"):
        P.make_mesh(6, cand_axis=4, device="cpu")
    reps = P.put_replicated(mesh, {"x": np.arange(3)})
    assert len(reps) == 8 and all(r is reps[0] for r in reps)
    arr = np.arange(16).reshape(8, 2)
    flat = P.put_read_sharded(mesh, arr, 0)
    assert [int(b[0, 0]) for b in flat] == list(range(0, 16, 2))
    by_r = P.put_read_sharded(mesh, arr, 0, flat=False)
    assert [int(b[0, 0]) for b in by_r] == [0, 4, 8, 12] * 2
    assert by_r[0] is by_r[4]  # one upload per (block, device)
    with pytest.raises(ValueError, match="padded"):
        P.put_read_sharded(mesh, np.arange(7), 0)
    from dbgphmm_tpu_torch.parallel.sharding import gather_to_host

    got = gather_to_host([torch.ones(2), np.zeros(1)], mesh)
    assert [a.tolist() for a in got] == [[1.0, 1.0], [0.0]]
    with pytest.raises(RuntimeError, match="no rank computed"):
        gather_to_host([None], mesh)
