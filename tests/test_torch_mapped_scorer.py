"""The port's candidate scorer (dbgphmm_tpu_torch.ops.mapped_scorer) against
the JAX package, on the fixture of tests/test_pallas_mapped.py.

On the CPU the K1 wrapper runs its plain PyTorch twin; the CUDA kernel is
held against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
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
from dbgphmm_tpu.ops.batch import candidate_log_likelihoods
from dbgphmm_tpu.ops.sparse import (
    forward_scores_mapped_pos,
    pad_mappings,
    precompute_positions,
)
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.phmm.template import make_template
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops import sparse as TS
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.phmm import template as port_template
from dbgphmm_tpu_torch.seq import collection as port_collection

STREAM_FIELDS = ("codes", "emis", "numce", "selfp", "prevp", "curp", "dence",
                 "lens")


@pytest.fixture(scope="module")
def setup():
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACG"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACG"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    params = PHMMParams.uniform(0.001)
    reads = ReadCollection([h1[2:26], h2[3:27], h1[:24], h2[4:]])
    maps = generate_mappings(dbg, params, reads, n_active=12)
    codes, lens = pad_reads(list(reads), pad_to=32)
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps, codes.shape[1], 12)
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    candidates = [dbg.get_copy_nums()] + [
        cn for cn, _i in to_short_neighbors(dbg, 8, 2)[:3]
    ] + [[0] * dbg.n_edges_compact()]  # last one: every read blocked (-inf)
    # the port's template and positions, from its own graph of the same
    # haplotypes and the same (JAX-decoded) mapping
    dbg_t = port_multi_dbg.MultiDbg.from_styled_seqs(
        8, [port_collection.StyledSequence.linear(h) for h in (h1, h2)])
    tpl_t = port_template.make_template(
        dbg_t, port_params.PHMMParams.uniform(0.001))
    pos_t = TS.precompute_positions(mn, tpl_t.parent_idx,
                                    parent_exists=tpl_t.parent_exists)
    return dbg, params, tpl, pos, codes, lens, candidates, tpl_t, pos_t


def _stream_tensors(s):
    return [torch.as_tensor(np.asarray(getattr(s, f)).astype(np.int32))
            for f in ("lens", "codes", "emis", "numce", "selfp", "prevp",
                      "curp", "dence")]


def _twin(s, cands, params, dtype):
    eff, total = T._eff_matrix(s, cands)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return T.mapped_scores_log(
        torch.as_tensor(eff, dtype=dtype),
        torch.as_tensor(T.log_inv_total(total), dtype=dtype),
        *_stream_tensors(s), torch.as_tensor(T.lin_params(params, np_dt)),
        n_max_gaps=params.n_max_gaps,
    ).numpy()


def test_positions_match_jax(setup):
    """The port builds its copy of positions.cpp into its own build
    directory; from its own template the slot positions are identical."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    for a, b in zip(pos_t, pos):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_streams_and_eff_tables_match_jax(setup):
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    ours = T.build_streams(tpl_t, pos_t, codes, lens)
    ref = J.build_streams(tpl, pos, codes, lens, dbg)
    for f in STREAM_FIELDS + ("emittable_len", "emittable_len_full"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.nc_pad == ref.nc_pad
    for a, b in zip(T.eff_tables(ours, cands), J.eff_tables(ref, cands)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_twin_matches_jax_f64_mapped_kernel(setup):
    """The twin in float64 equals forward_scores_mapped_pos in float64 per
    read to 1e-6 nats (both are the same exact recursion; the twin's
    finite -1e30 sentinel changes nothing above it), -inf where it is."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    s = T.build_streams(tpl_t, pos_t, codes, lens)
    calls = T.mapped_scores_log_reference.calls
    launches = T.mapped_scores_log.launches
    got = _twin(s, cands, params, torch.float64)
    # CPU tensors go to the twin, never to the kernel
    assert T.mapped_scores_log_reference.calls == calls + 1
    assert T.mapped_scores_log.launches == launches
    B = codes.shape[0]
    for c, cn in enumerate(cands):
        dm = to_device(tpl.model_for(cn), dtype=jnp.float64)
        ref = np.asarray(forward_scores_mapped_pos(
            dm, jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(pos.map_nodes), jnp.asarray(pos.prev_pos),
            jnp.asarray(pos.cur_pos), jnp.asarray(pos.self_pos)))
        np.testing.assert_array_equal(np.isneginf(got[c, :B]), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[c, :B][fin], ref[fin], rtol=0, atol=1e-6)
    assert np.isneginf(got[-1, :B]).all()


def test_twin_matches_jax_packed_kernel(setup):
    """The twin in float32 against the JAX packed Pallas kernel (K1) in
    interpret mode at P=8, CL=1, renorm_every=2: atol 2e-3, rtol 1e-5, the
    bound the JAX tests use for float32."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    s = J.build_streams(tpl, pos, codes, lens, dbg)
    A = s.emis.shape[2]
    eff, linv, _cp = J.pack_eff_tables(s, cands, 8, 1, A)
    ltv = J.lin_params_from_phmm_params(params)
    args = [jnp.asarray(getattr(s, f)) for f in
            ("lens", "codes", "emis", "numce", "selfp", "prevp", "curp",
             "dence")]
    ref = np.asarray(J.pallas_mapped_scores_packed(
        jnp.asarray(eff), jnp.asarray(linv), *args, ltv,
        n_max_gaps=params.n_max_gaps, TL=8, P=8, CL=1, interpret=True,
        renorm_every=2))
    C, B = len(cands), codes.shape[0]
    got = _twin(T.build_streams(tpl_t, pos_t, codes, lens), cands, params,
                torch.float32)
    a, b = got[:C, :B], ref[:C, :B]
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], atol=2e-3, rtol=1e-5)


def _widened(setup, n_tile=5, wide_every=4, width=40):
    """The fixture tiled to 20 reads, every 4th read's sets padded with
    extra (valid, unrelated) nodes up to ``width`` slots, so the width sort
    puts reads of A=16 and A=64 into different read chunks."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    codes = np.concatenate([codes] * n_tile)
    lens = np.concatenate([lens] * n_tile)
    mn = np.concatenate([pos.map_nodes] * n_tile)
    B, L, A0 = mn.shape
    wide = np.full((B, L, width), -1, dtype=np.int32)
    wide[:, :, :A0] = mn
    n = tpl.parent_idx.shape[0]
    for b in range(0, B, wide_every):
        for j in range(lens[b]):
            row = set(mn[b, j][mn[b, j] >= 0].tolist())
            extra = [v for v in range(n) if v not in row][: width - len(row)]
            wide[b, j, len(row):] = extra
    pos_w = precompute_positions(wide, tpl.parent_idx,
                                 parent_exists=tpl.parent_exists)
    pos_w_t = TS.precompute_positions(wide, tpl_t.parent_idx,
                                      parent_exists=tpl_t.parent_exists)
    return codes, lens, pos_w, pos_w_t


def test_scorer_matches_jax_with_mixed_width_read_chunks(setup):
    """MappedScorer.scores_detailed equals JAX candidate_log_likelihoods
    (float64, 1e-6 nats) with read chunks of different slot width A — the
    case where the JAX Pallas scorer's chunk rows disagree (CAND_SUB sized
    from the widest chunk) — and per_read comes back in the original read
    order."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    codes, lens, pos_w, pos_w_t = _widened(setup)
    scorer = T.MappedScorer(tpl_t, pos_w_t, codes, lens, tpl_t.params, "cpu",
                            read_chunk=8)
    widths = sorted({s.emis.shape[2] for s in scorer.chunks})
    assert len(scorer.chunks) == 3 and widths == [16, 64], widths
    sums, ok = scorer.scores_detailed(cands)
    ref = candidate_log_likelihoods([tpl.model_for(cn) for cn in cands],
                                    codes, lens, positions=pos_w)
    np.testing.assert_array_equal(np.isneginf(sums), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(sums[fin], ref[fin], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ok, np.isfinite(ref))

    per = scorer.per_read(cands[:2])
    for c in range(2):
        dm = to_device(tpl.model_for(cands[c]), dtype=jnp.float64)
        ref_r = np.asarray(forward_scores_mapped_pos(
            dm, jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(pos_w.map_nodes), jnp.asarray(pos_w.prev_pos),
            jnp.asarray(pos_w.cur_pos), jnp.asarray(pos_w.self_pos)))
        np.testing.assert_allclose(per[c], ref_r, rtol=0, atol=1e-6)


def test_live_columns_and_live_degree_columns(setup):
    """What the K1 / K2 wrappers derive from their inputs: eff columns from
    ``live_columns`` on are 0 for every candidate and the one before is not
    (the kernels stage only the ones before), and ``live_degree_columns``
    is, per position, the count of leading degree columns any slot uses."""
    dbg, params, tpl, pos, codes, lens, cands, tpl_t, pos_t = setup
    for s in (T.build_streams(tpl_t, pos_t, codes, lens),
              T.MappedScorer(tpl_t, pos_t, codes, lens, params, "cpu").chunks[0]):
        eff, _total = T._eff_matrix(s, cands)
        n_live = T.live_columns(torch.as_tensor(eff))
        assert n_live < s.nc_pad - 1
        assert not eff[:, n_live:].any() and eff[:, n_live - 1].any()
        prevp, curp, dence = (torch.as_tensor(np.asarray(getattr(s, f)),
                                              dtype=torch.int32)
                              for f in ("prevp", "curp", "dence"))
        got = T.live_degree_columns(prevp, curp, dence, n_live).numpy()
        L, D, B, A = s.prevp.shape
        ref = np.ones((L, B), dtype=np.int32)
        for d in range(1, D):
            used = ((s.prevp[:, d] >= 0) | (s.curp[:, d] >= 0)
                    | (s.dence[:, d] < n_live)).any(axis=-1)
            ref = np.where(used, d + 1, ref)
        np.testing.assert_array_equal(got, ref)
        assert 1 < got.max() <= D
