"""The port's K2 and K3 twins and the scorer's three spaces against the JAX
package, on the fixture of tests/test_pallas_mapped.py.

K2 (``mapped_scores_log_single``) is the per-candidate log-space scorer of
the TPU's ``_make_kernel_log``, K3 (``mapped_scores_linear``) the
scaled-linear scorer of ``_make_kernel``.  On the CPU each wrapper runs its
plain PyTorch twin; the CUDA kernels are held against the twins on the
card (tests/test_torch_cuda.py, chip_smoke.py).  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg.neighbors import to_short_neighbors
from dbgphmm_tpu.multi_dbg.posterior import generate_mappings
from dbgphmm_tpu.ops import pad_reads, to_device
from dbgphmm_tpu.ops import pallas_mapped as J
from dbgphmm_tpu.ops.sparse import (
    forward_scores_mapped_linear,
    forward_scores_mapped_pos,
    pad_mappings,
    precompute_positions,
)
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.template import make_template
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu.seq.random_seq import generate
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch.multi_dbg import output as port_output
from dbgphmm_tpu_torch.multi_dbg import posterior as TP
from dbgphmm_tpu_torch.multi_dbg.seed import seed_mappings_arrays
from dbgphmm_tpu_torch.e2e import Dataset
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops.forward import pad_reads as port_pad_reads
from dbgphmm_tpu_torch.ops import sparse as TS
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.phmm import template as port_template
from dbgphmm_tpu_torch.seq import collection as port_collection

from test_torch_mapped_scorer import _stream_tensors, _widened, setup  # noqa: F401
from test_torch_posterior import one_torch_thread  # noqa: F401

TWINS = {"log": (T.mapped_scores_log_single, T.log_inv_total),
         "linear": (T.mapped_scores_linear, T.lin_inv_total)}


def _twin(space, s, cands, params, dtype):
    fn, inv_of = TWINS[space]
    eff, total = T._eff_matrix(s, cands)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return fn(
        torch.as_tensor(eff, dtype=dtype),
        torch.as_tensor(inv_of(total), dtype=dtype),
        *_stream_tensors(s), torch.as_tensor(T.lin_params(params, np_dt)),
        n_max_gaps=params.n_max_gaps,
    ).numpy()


def _jax_kernel(space, setup, cands):
    dbg, params, tpl, pos, codes, lens, _c, _tt, _pt = setup
    s = J.build_streams(tpl, pos, codes, lens, dbg)
    eff, inv_total = J.eff_tables(s, cands)
    args = [jnp.asarray(getattr(s, f)) for f in
            ("lens", "codes", "emis", "numce", "selfp", "prevp", "curp",
             "dence")]
    return np.asarray(J.pallas_mapped_scores(
        jnp.asarray(eff), jnp.asarray(inv_total), *args,
        J.lin_params_from_phmm_params(params), n_max_gaps=params.n_max_gaps,
        TL=8, interpret=True, space=space))


def _jax_f64(ref_fn, tpl, pos, codes, lens, cn):
    dm = to_device(tpl.model_for(cn), dtype=jnp.float64)
    return np.asarray(ref_fn(
        dm, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(pos.map_nodes),
        jnp.asarray(pos.prev_pos), jnp.asarray(pos.cur_pos),
        jnp.asarray(pos.self_pos)))


def _blocked(setup):
    """The fixture's candidates plus two that zero a compact edge the reads
    cross: edge 0 (the candidate of test_pallas_log_kernel_matches_f64;
    every read -inf, in the reference too) and the last edge (reads
    re-enter through the Begin chain: very low, finite in log space)."""
    cands = setup[6]
    zero_first, zero_last = list(cands[0]), list(cands[0])
    zero_first[0] = zero_last[-1] = 0
    return cands + [zero_first, zero_last]


@pytest.mark.parametrize("space", ["log", "linear"])
def test_twin_f32_matches_jax_pallas_kernel(setup, space):
    """float32 twin against the Pallas kernel of the same space in
    interpret mode: atol 2e-3, rtol 1e-5 (tests/test_pallas_mapped.py:84),
    the same -inf pattern.  The K2 twin's closed-form Begin chain differs
    from the TPU arithmetic only by float32 rounding on these short reads."""
    dbg, params, tpl, pos, codes, lens, _c, tpl_t, pos_t = setup
    cands = _blocked(setup)
    ref = _jax_kernel(space, setup, cands)
    got = _twin(space, T.build_streams(tpl_t, pos_t, codes, lens), cands, params,
                torch.float32)
    C, B = len(cands), codes.shape[0]
    a, b = got[:C, :B], ref[:C, :B]
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], atol=2e-3, rtol=1e-5)


def test_linear_twin_f64_matches_forward_scores_mapped_linear(setup):
    """The K3 twin in float64 equals the XLA scaled-linear recursion in
    float64 per read to 1e-6 nats, -inf where it is (the all-zero
    candidate)."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    calls = T.mapped_scores_linear_reference.calls
    launches = T.mapped_scores_linear.launches
    got = _twin("linear", T.build_streams(tpl_t, pos_t, codes, lens), cands,
                params, torch.float64)
    assert T.mapped_scores_linear_reference.calls == calls + 1
    assert T.mapped_scores_linear.launches == launches
    B = codes.shape[0]
    for c, cn in enumerate(cands):
        ref = _jax_f64(forward_scores_mapped_linear, tpl, pos, codes, lens, cn)
        np.testing.assert_array_equal(np.isneginf(got[c, :B]), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[c, :B][fin], ref[fin], rtol=0, atol=1e-6)
    assert np.isneginf(got[-1, :B]).all()


def test_log_single_twin_f64_matches_forward_scores_mapped_pos(setup):
    """The K2 twin in float64 equals forward_scores_mapped_pos in float64
    per read to 1e-6 nats, including the blocked candidate, and is -inf
    exactly where the reference is."""
    dbg, params, tpl, pos, codes, lens, _c, tpl_t, pos_t = setup
    cands = _blocked(setup)
    calls = T.mapped_scores_log_single_reference.calls
    launches = T.mapped_scores_log_single.launches
    got = _twin("log", T.build_streams(tpl_t, pos_t, codes, lens), cands, params,
                torch.float64)
    assert T.mapped_scores_log_single_reference.calls == calls + 1
    assert T.mapped_scores_log_single.launches == launches
    B = codes.shape[0]
    for c, cn in enumerate(cands):
        ref = _jax_f64(forward_scores_mapped_pos, tpl, pos, codes, lens, cn)
        np.testing.assert_array_equal(np.isneginf(got[c, :B]), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[c, :B][fin], ref[fin], rtol=0, atol=1e-6)
    assert np.isneginf(got[-2, :B]).all()
    assert np.isfinite(got[-1, :B]).all()  # blocked, but finite in log space


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-3)])
def test_log_single_twin_matches_k1_twin(setup, dtype, atol):
    """K2 and K1 compute the same quantity and differ only in how often
    they renormalise: per read, the same -inf pattern and values."""
    dbg, params, tpl, pos, codes, lens, _c, tpl_t, pos_t = setup
    cands = _blocked(setup)
    s = T.build_streams(tpl_t, pos_t, codes, lens)
    k2 = _twin("log", s, cands, params, dtype)
    eff, total = T._eff_matrix(s, cands)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    k1 = T.mapped_scores_log(
        torch.as_tensor(eff, dtype=dtype),
        torch.as_tensor(T.log_inv_total(total), dtype=dtype),
        *_stream_tensors(s), torch.as_tensor(T.lin_params(params, np_dt)),
        n_max_gaps=params.n_max_gaps).numpy()
    np.testing.assert_array_equal(np.isneginf(k2), np.isneginf(k1))
    fin = np.isfinite(k1)
    np.testing.assert_allclose(k2[fin], k1[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("space", ["packed", "log", "linear"])
def test_scorer_space_matches_jax_pallas_scorer(setup, space):
    """MappedScorer(space=) against PallasMappedScorer(space=) in interpret
    mode, with read chunks of A=16 and A=64 side by side in the port
    (tests/test_pallas_mapped.py:163-188 and :366): sums to atol 5e-3,
    rtol 1e-5 (float64 twin against float32 Pallas), the same ok flags."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    codes, lens, pos_w, pos_w_t = _widened(setup)
    ours = T.MappedScorer(tpl_t, pos_w_t, codes, lens, tpl_t.params, "cpu",
                          read_chunk=8, space=space)
    assert sorted({s.emis.shape[2] for s in ours.chunks}) == [16, 64]
    ref = J.PallasMappedScorer(tpl, pos_w, codes, lens, tpl.params,
                               space=space, read_chunk=8)
    assert ref.interpret
    sums, ok = ours.scores_detailed(cands)
    ref_sums, ref_ok = ref.scores_detailed(cands)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not ok[-1]  # the all-zero candidate: an empty table, -inf
    np.testing.assert_array_equal(np.isneginf(sums), np.isneginf(ref_sums))
    fin = np.isfinite(ref_sums)
    np.testing.assert_allclose(sums[fin], ref_sums[fin], atol=5e-3, rtol=1e-5)


def test_log_sibling_shares_the_uploaded_streams(setup):
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    lin = T.MappedScorer(tpl_t, pos_t, codes, lens, tpl_t.params, "cpu",
                         space="linear")
    sib = lin.log_sibling()
    assert (lin.space, sib.space) == ("linear", "log")
    assert sib._dev is lin._dev and sib.chunks is lin.chunks
    with pytest.raises(ValueError, match="space"):
        T.MappedScorer(tpl_t, pos_t, codes, lens, tpl_t.params, "cpu",
                       space="lin")


@pytest.fixture(scope="module")
def long_bubble():
    """Two haplotypes that differ by a 110-base stretch: the k=8 graph has
    a long bubble.  Reads of the second haplotype cross its branch whole,
    so a candidate that moves the branch's copy onto the other one forces
    them through ~117 positions of copy-0 edges.  The scaled-linear
    recursion underflows there even in float64 (the Begin chain loses ~3.6
    decades a base); the log-space recursion stays finite.  The mapping is
    the JAX package's decode (the port has no small-graph decode); the
    graph, template and positions the port scores with are its own."""
    a, x, y, b = (generate(n, s) for n, s in ((40, 1), (110, 2), (110, 3),
                                               (40, 4)))
    h1, h2 = a + x + b, a + y + b
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    params = PHMMParams.uniform(0.001)
    reads = ReadCollection([h1[5:185], h2[0:180], h2[10:190], h1[0:175]])
    maps = generate_mappings(dbg, params, reads, n_active=12)
    codes, lens = pad_reads(list(reads))
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps, codes.shape[1], 12)
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    cands = [dbg.get_copy_nums()] + [cn for cn, _i in
                                     to_short_neighbors(dbg, 8, 2)]
    dbg_t = port_multi_dbg.MultiDbg.from_styled_seqs(
        8, [port_collection.StyledSequence.linear(h) for h in (h1, h2)])
    assert dbg_t.get_copy_nums() == dbg.get_copy_nums()
    tpl_t = port_template.make_template(
        dbg_t, port_params.PHMMParams.uniform(0.001))
    pos_t = TS.precompute_positions(mn, tpl_t.parent_idx,
                                    parent_exists=tpl_t.parent_exists)
    return dbg_t, tpl_t, pos_t, codes, lens, cands


def test_score_candidates_rescues_the_linear_scorers_flagged_candidates(
        long_bubble, monkeypatch):
    """score_candidates with a linear scorer rescores exactly the flagged
    candidates through the log sibling (K2's twin here) and puts their sums
    in place; the others keep the linear sums.  A log scorer is never
    rescored: its -inf is exact."""
    dbg, tpl, pos, codes, lens, cands = long_bubble
    lin = TP.make_scorer(tpl, pos, codes, lens, tpl.params, "cpu",
                         space="linear")
    lin_sums, ok = lin.scores_detailed(cands)
    log_sums, log_ok = lin.log_sibling().scores_detailed(cands)
    assert 0 < (~ok).sum() < len(cands), ok
    assert log_ok.all()

    seen = []
    twin = T.mapped_scores_log_single_reference

    def spy(eff, *a, **kw):
        seen.append(eff.shape[0])
        return twin(eff, *a, **kw)

    spy.calls = 0  # the twin counts its calls on the module's name
    monkeypatch.setattr(T, "mapped_scores_log_single_reference", spy)
    times = TP.StageTimes(k=dbg.k)
    scores = TP.score_candidates(dbg, cands, 400, 10, lin, times)
    assert seen == [int((~ok).sum())] * len(lin.chunks)
    assert times.n_rescued == int((~ok).sum())
    got = np.asarray([s.likelihood for s in scores])
    np.testing.assert_array_equal(got[~ok], log_sums[~ok])
    np.testing.assert_array_equal(got[ok], lin_sums[ok])

    seen.clear()
    log_scorer = TP.make_scorer(tpl, pos, codes, lens, tpl.params, "cpu",
                                space="log")
    TP.score_candidates(dbg, cands, 400, 10, log_scorer)
    assert seen == [len(cands)] * len(log_scorer.chunks)  # no second call


# -- what the K3 kernel relies on, shown on its twin ---------------------------


@pytest.fixture(scope="module")
def bench_case():
    """Streams of the committed real draft (data/bench, k=40; 43,743 full
    edges): 6 reads cut to 600 bases, mapped by the seed chain alone, in
    one read chunk with its compact ids trimmed as in production.  Four
    candidates: the draft's copy numbers and three with 5% of the compact
    edges moved by -1..+1, all with the chunk's last 30 compact ids at 0,
    so that ids past the live columns occur."""
    ds = Dataset.from_json_file("data/bench/data.json")
    dbg = port_output.from_dbg_file("data/bench/data.dbg")
    params = port_params.PHMMParams.uniform(0.001)
    reads = [r[:600] for r in list(ds.reads)[:6]]
    seeds = seed_mappings_arrays(dbg, reads)
    hint = TP.Mappings(seeds, [np.zeros(a.shape) for a in seeds], None, None, -1)
    codes, lens = port_pad_reads(reads)
    tpl = port_template.make_template(dbg, params)
    mn = TS.pad_mappings(hint, codes.shape[1], max(a.shape[1] for a in seeds))
    pos = TS.precompute_positions(mn, tpl.parent_idx,
                                  parent_exists=tpl.parent_exists)
    scorer = T.MappedScorer(tpl, pos, codes, lens, params, "cpu")
    assert len(scorer.chunks) == 1
    s = scorer.chunks[0]
    rng = np.random.default_rng(5)
    base = np.asarray(dbg.get_copy_nums())
    cands = [base] + [np.maximum(base + np.where(rng.random(base.size) < 0.05,
                                                 rng.integers(-1, 2, base.size),
                                                 0), 0) for _ in range(3)]
    for cn in cands:
        cn[s.ce_ids[-30:]] = 0
    eff, total = T._eff_matrix(s, [cn.tolist() for cn in cands])
    return dict(eff=eff, inv=T.lin_inv_total(total), streams=scorer.block_streams(0),
                sentinel=s.nc_pad - 1)


def synthetic_case():
    """Random streams shaped like a de Bruijn graph read's (D = 4, A = 32):
    most positions have one parent per slot and one out-edge per source
    node, 5% are branch positions; eff columns from n_live = 128 on are 0
    for every candidate, and the unused out-edge columns hold ids anywhere
    in [n_live, NC)."""
    rng = np.random.default_rng(11)
    L, D, B, A, NC, C, n_live = 200, 4, 8, 32, 256, 5, 128
    emis = rng.integers(0, 4, (L, B, A))
    emis[rng.random((L, B, A)) < 0.2] = 9
    branch = rng.random((L, 1, B, A)) < 0.05
    prevp = rng.integers(-1, A, (L, D, B, A))
    curp = rng.integers(-1, A, (L, D, B, A))
    dence = rng.integers(0, n_live, (L, D, B, A))
    numce = rng.integers(0, n_live, (L, B, A))
    dead = rng.random((L, B, A)) < 0.1  # edges at copy number 0 everywhere
    numce[dead] = rng.integers(n_live, NC, int(dead.sum()))
    for x in (prevp, curp):
        x[:, 1:] = np.where(branch, x[:, 1:], -1)
    dence[:, 1:] = np.where(branch, dence[:, 1:],
                            rng.integers(n_live, NC, (L, D - 1, B, A)))
    dence[:, 0] = np.where(branch[:, 0], dence[:, 0], numce)
    eff = rng.integers(0, 4, (C, NC)).astype(np.float32)
    eff[:, n_live:] = 0.0
    eff[:, n_live - 1] = 1.0
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    streams = [i32(a) for a in (rng.integers(L // 2, L + 1, B),
                                rng.integers(0, 4, (L, B)), emis, numce,
                                rng.integers(-1, A, (L, B, A)), prevp, curp,
                                dence)]
    inv = 1.0 / rng.integers(1000, 100000, C).astype(np.float64)
    return dict(eff=eff, inv=inv, streams=streams, sentinel=NC - 1)


def _case(name, request):
    return request.getfixturevalue("bench_case") if name == "bench" \
        else synthetic_case()


def _k3_twin(case, dtype, eff=None, streams=None):
    lt = T.lin_params(port_params.PHMMParams.uniform(0.001), np.float64)
    eff = torch.as_tensor(case["eff"] if eff is None else eff, dtype=dtype)
    return T.mapped_scores_linear(
        eff, torch.as_tensor(case["inv"], dtype=dtype),
        *(case["streams"] if streams is None else streams),
        torch.as_tensor(lt, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["bench", "synthetic"])
def test_linear_twin_on_the_live_columns_only(name, dtype, request):
    """The table the K3 kernel stages: each candidate's eff over the live
    columns (live_columns) plus one zero column that serves every compact
    id at or past them.  The twin on that table, with every id past the
    live columns sent to the zero column, equals the twin on the full table
    bit for bit."""
    case = _case(name, request)
    eff = torch.as_tensor(case["eff"])
    n_live = T.live_columns(eff)
    assert n_live < eff.shape[1] - 1
    lens, codes, emis, numce, selfp, prevp, curp, dence = case["streams"]
    assert (numce >= n_live).any() and (dence >= n_live).any()
    cut = torch.cat([eff[:, :n_live], torch.zeros((eff.shape[0], 1))], dim=1)
    streams = (lens, codes, emis, numce.clamp(max=n_live), selfp, prevp, curp,
               dence.clamp(max=n_live))
    full = _k3_twin(case, dtype)
    assert torch.isfinite(full).any()
    assert torch.equal(_k3_twin(case, dtype, eff=cut.numpy(), streams=streams),
                       full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["bench", "synthetic"])
def test_columns_past_the_live_degree_columns_add_nothing(name, dtype, request):
    """K3 runs a position with only its first live_degree_columns degree
    columns.  The twin with every later column emptied at each position
    (no parent, the sentinel out-edge) equals the twin on the streams as
    they are, bit for bit; the emptying changes the streams."""
    case = _case(name, request)
    lens, codes, emis, numce, selfp, prevp, curp, dence = case["streams"]
    L, D, B, A = prevp.shape
    ncols = T.live_degree_columns(prevp, curp, dence,
                                  T.live_columns(torch.as_tensor(case["eff"])))
    assert (ncols < D).any()
    past = torch.arange(D).view(1, D, 1, 1) >= ncols.view(L, 1, B, 1)
    emptied = (prevp.masked_fill(past, -1), curp.masked_fill(past, -1),
               dence.masked_fill(past, case["sentinel"]))
    assert not torch.equal(emptied[2], dence)
    streams = (lens, codes, emis, numce, selfp, *emptied)
    assert torch.equal(_k3_twin(case, dtype, streams=streams),
                       _k3_twin(case, dtype))
