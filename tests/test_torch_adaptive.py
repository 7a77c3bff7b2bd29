"""The port's sparse-adaptive decode (dbgphmm_tpu_torch.ops.adaptive)
against the JAX package, in float64 on the CPU (mirrors
tests/test_adaptive.py's frontier tests).

Each package builds its own model from the same inputs.  Gates: read
log-likelihoods to 1e-9 relative, identical map_nodes, finite map_logp to
1e-8; the stored-table and frontier helpers give the same node sets.
"""

import jax.numpy as jnp
import numpy as np
import torch

import dbgphmm_tpu.multi_dbg.posterior as JP
import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu import ops as J
from dbgphmm_tpu.multi_dbg import MultiDbg as JMultiDbg
from dbgphmm_tpu.ops import adaptive as JA
from dbgphmm_tpu.ops import sparse as JS
from dbgphmm_tpu.phmm import model as jax_model
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.seq import collection as jax_collection
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.ops import adaptive as A
from dbgphmm_tpu_torch.ops import forward as T
from dbgphmm_tpu_torch.ops.sparse import forward_scores_mapped
from dbgphmm_tpu_torch.phmm import PHMMParams
from dbgphmm_tpu_torch.phmm import model as port_model
from dbgphmm_tpu_torch.seq import collection as port_collection
from dbgphmm_tpu_torch.seq.collection import StyledSequence
from dbgphmm_tpu_torch.seq.random_seq import generate

from test_torch_posterior import one_torch_thread  # noqa: F401


def random_linear(n, seed, dtype=torch.float64):
    """(port model on the CPU, JAX model) of linear_random_phmm(n, seed)."""
    pm = port_model.linear_random_phmm(n, seed, PHMMParams.default())
    jm = jax_model.linear_random_phmm(n, seed, jax_params.PHMMParams.default())
    return (T.to_device(pm, "cpu", dtype),
            J.to_device(jm, dtype=jnp.float64 if dtype == torch.float64
                        else jnp.float32))


def codes_of(reads):
    codes, lens = T.pad_reads(reads)
    return (torch.as_tensor(codes), torch.as_tensor(lens), jnp.asarray(codes),
            jnp.asarray(lens))


def same_decode(got, ref):
    lp, mn, ml = (a.numpy() for a in got)
    jlp, jmn, jml = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(lp, jlp, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(mn, jmn)
    fin = np.isfinite(jml)
    np.testing.assert_array_equal(np.isfinite(ml), fin)
    np.testing.assert_allclose(ml[fin].astype(np.float64), jml[fin], rtol=0,
                               atol=1e-8)


def test_adaptive_forward_score_matches_dense():
    """The adaptive forward drops negligible mass (< 1e-6 against the
    dense score); e and the stored tables equal the JAX package's."""
    dm, jdm = random_linear(300, 0)
    seq = generate(300, 0)
    c, l, jc, jl = codes_of([seq[20:220], seq[100:290]])
    dense = T.forward_scores(dm, c, l, renorm=False)
    f = A.forward_sparse_adaptive(dm, c, l, n_top=40)
    assert np.all(np.abs((f.e - dense).numpy()) < 1e-6)
    jf = JA.forward_sparse_adaptive(jdm, jc, jl, n_top=40)
    np.testing.assert_allclose(f.e.numpy(), np.asarray(jf.e), rtol=1e-9)
    np.testing.assert_array_equal(f.nodes.numpy(), np.asarray(jf.nodes))
    np.testing.assert_allclose(f.off.numpy(), np.asarray(jf.off), rtol=1e-9,
                               atol=1e-12)


def test_adaptive_truncation_keeps_top_nodes():
    """n_top * (D + 1) > n: the cut after dedup keeps the score-ranked top
    nodes (a read from the graph's high-id end stays finite)."""
    dm, jdm = random_linear(100, 0)
    seq = generate(100, 0)
    c, l, jc, jl = codes_of([seq[60:95]])
    dense = T.forward_scores(dm, c, l, renorm=False)
    f = A.forward_sparse_adaptive(dm, c, l, n_top=60, n_warmup=4)
    assert torch.isfinite(f.e).all()
    assert np.all(np.abs((f.e - dense).numpy()) < 1e-6)
    jf = JA.forward_sparse_adaptive(jdm, jc, jl, n_top=60, n_warmup=4)
    np.testing.assert_allclose(f.e.numpy(), np.asarray(jf.e), rtol=1e-9)
    np.testing.assert_array_equal(f.nodes.numpy(), np.asarray(jf.nodes))


def test_adaptive_mappings_match_dense_mappings():
    """Top-1 node agrees with the dense decode at > 98% of positions; the
    decode equals the JAX package's."""
    dm, jdm = random_linear(200, 1)
    seq = generate(200, 1)
    c, l, jc, jl = codes_of([seq[10:150]])
    _lp, _f, mn_dense, _ml = T.node_freqs_and_mappings(dm, c, l, renorm=False,
                                                       n_active=5)
    got = A.mappings_sparse_adaptive(dm, c, l, n_top=40, n_active=5)
    a, b = mn_dense.numpy()[0], got[1].numpy()[0]
    L = int(l[0])
    assert np.mean(a[:L, 0] == b[:L, 0]) > 0.98
    assert np.mean([len(set(a[j]) & set(b[j])) / 5.0 for j in range(L)]) > 0.9
    same_decode(got, JA.mappings_sparse_adaptive(jdm, jc, jl, n_top=40,
                                                 n_active=5))


def test_adaptive_on_dbg():
    """The adaptive mapping of a repeat DBG feeds the mapped forward: within
    0.1 of the dense score; both equal the JAX package's."""
    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTT"
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)])
    jdbg = JMultiDbg.from_styled_seqs(8, [jax_collection.StyledSequence.linear(seq)])
    p, jp = PHMMParams.uniform(0.001), jax_params.PHMMParams.uniform(0.001)
    dm = T.to_device(dbg.to_phmm(p, mode="non_zero"), "cpu")
    jdm = J.to_device(jdbg.to_phmm(jp, mode="non_zero"), dtype=jnp.float64)
    c, l, jc, jl = codes_of([seq[2:26], seq[0:20]])
    got = A.mappings_sparse_adaptive(dm, c, l, n_top=10, n_active=8)
    ref = JA.mappings_sparse_adaptive(jdm, jc, jl, n_top=10, n_active=8)
    assert torch.isfinite(got[0]).all()
    same_decode(got, ref)
    dmn = T.to_device(dbg.to_phmm(p), "cpu")
    s_mapped = forward_scores_mapped(dmn, c, l, got[1])
    s_dense = T.forward_scores(dmn, c, l, renorm=False)
    assert np.all(np.abs((s_mapped - s_dense).numpy()) < 0.1)
    jdmn = J.to_device(jdbg.to_phmm(jp), dtype=jnp.float64)
    np.testing.assert_allclose(
        s_mapped.numpy(),
        np.asarray(JS.forward_scores_mapped(jdmn, jc, jl, ref[1], renorm=True)),
        rtol=1e-9)


def _diploid(jax):
    col = jax_collection if jax else port_collection
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGA"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGA"
    dbg = (JMultiDbg if jax else MultiDbg).from_styled_seqs(
        8, [col.StyledSequence.linear(h1), col.StyledSequence.linear(h2)])
    reads = col.ReadCollection([h1[1:25], h2[3:27], h1[:20]])
    params = (jax_params.PHMMParams if jax else PHMMParams).uniform(0.001)
    return dbg, reads, params


def _node_sets(maps):
    return [[set(m[j][m[j] >= 0].tolist()) for j in range(m.shape[0])]
            for m in maps.nodes]


def test_dense_compute_regime_matches_dense_store(monkeypatch):
    """The dense-compute / compact-store regime (n_warmup = L) gives the
    dense decode's node sets; and the JAX package's mapping in that
    regime."""
    dbg, reads, params = _diploid(False)
    exact = TP.generate_mappings(dbg, params, reads, "cpu")
    monkeypatch.setattr(TP, "DENSE_MAPPING_MAX_NODES", 0)
    monkeypatch.setattr(JP, "DENSE_MAPPING_MAX_NODES", 0)
    got = TP.generate_mappings(dbg, params, reads, "cpu")
    assert _node_sets(got) == _node_sets(exact)
    jdbg, jreads, jparams = _diploid(True)
    ref = JP.generate_mappings(jdbg, jparams, jreads)
    np.testing.assert_allclose(got.read_logps, ref.read_logps, rtol=1e-9)
    for a, b in zip(got.nodes, ref.nodes):
        np.testing.assert_array_equal(a, b)


def test_frontier_decode_without_seeding_matches_jax(monkeypatch):
    """Above DENSE_COMPUTE_MAX_NODES with DBGPHMM_SEED_MAPPING=0 (the bound
    lowered to 0 here): the evolving-frontier decode (n_warmup 16, stored_k,
    float64 storage on the CPU), the JAX package's mapping."""
    monkeypatch.setenv("DBGPHMM_SEED_MAPPING", "0")
    for P in (TP, JP):
        monkeypatch.setattr(P, "DENSE_MAPPING_MAX_NODES", 0)
        monkeypatch.setattr(P, "DENSE_COMPUTE_MAX_NODES", 0)
    assert not TP.seeded_mapping_enabled()
    dbg, reads, params = _diploid(False)
    got = TP.generate_mappings(dbg, params, reads, "cpu")
    jdbg, jreads, jparams = _diploid(True)
    ref = JP.generate_mappings(jdbg, jparams, jreads)
    assert np.isfinite(got.read_logps).all()
    np.testing.assert_allclose(got.read_logps, ref.read_logps, rtol=1e-9)
    np.testing.assert_array_equal(got.anchor_logps, got.read_logps)
    for a, b in zip(got.nodes, ref.nodes):
        np.testing.assert_array_equal(a, b)


def test_compact_stored_decode_matches_full_storage():
    """stored_k + bf16 storage (float32 carry, as on a GPU): the read
    log-likelihood equals full storage's bit for bit and the top-1 nodes
    agree at > 99% of positions; the bf16 tables promote to float32 in the
    decode (the JAX package's promotion) and equal its mapping's top-1."""
    dm, jdm = random_linear(300, 7, dtype=torch.float32)
    seq = generate(300, 7)
    c, l, jc, jl = codes_of([seq[20:220], seq[60:260], seq[0:190]])
    full = A.mappings_sparse_adaptive(dm, c, l, n_top=40, n_active=16)
    compact = A.mappings_sparse_adaptive(dm, c, l, n_top=40, n_active=16,
                                         stored_k=48, store_bf16=True)
    assert compact[2].dtype == torch.float32
    assert torch.equal(full[0], compact[0])
    for b, L in enumerate(l.tolist()):
        assert np.mean((full[1][b, :L, 0] == compact[1][b, :L, 0]).numpy()) > 0.99
    f = A.forward_sparse_adaptive(dm, c, l, n_top=40, stored_k=48,
                                  store_bf16=True)
    assert f.m.dtype == torch.bfloat16 and f.m.shape[2] == 48
    assert (f.m[0] + torch.zeros(1, dtype=torch.float32)).dtype == torch.float32
    ref = JA.mappings_sparse_adaptive(jdm, jc, jl, n_top=40, n_active=16,
                                      stored_k=48, store_bf16=True)
    for b, L in enumerate(l.tolist()):
        agree = np.mean(compact[1].numpy()[b, :L, 0] == np.asarray(ref[1])[b, :L, 0])
        assert agree > 0.99, (b, agree)


def test_frontier_helpers_match_jax():
    """_dedup_nodes (stable: the earliest slot keeps an id),
    _initial_active, _dense_to_sparse, and _next_active_attrs's slot
    gathers against the JAX one-hot product: the same node sets."""
    rows = np.array([[5, 3, 5, -1, 3, 7], [2, 2, 2, 0, -1, 0]], dtype=np.int32)
    got = A._dedup_nodes(torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, [[5, 3, -1, -1, -1, 7],
                                        [2, -1, -1, 0, -1, -1]])
    np.testing.assert_array_equal(got, np.asarray(JA._dedup_nodes(jnp.asarray(rows))))

    dm, jdm = random_linear(120, 3)
    np.testing.assert_array_equal(A._initial_active(dm, 2, 10).numpy(),
                                  np.asarray(JA._initial_active(jdm, 2, 10)))
    seq = generate(120, 3)
    c, l, jc, jl = codes_of([seq[5:60], seq[30:110]])
    fst, _ = T.forward_tables(dm, c[:, :20], l.clamp(max=20))
    jfst, _ = J.forward_tables(jdm, jc[:, :20], jnp.minimum(jl, 20))
    st = A._dense_to_sparse(fst, 36)
    jst = JA._dense_to_sparse(jfst, 36)
    np.testing.assert_array_equal(st.nodes.numpy(), np.asarray(jst.nodes))
    pk = A._pack_model(dm)
    attrs = A._gather_attrs(pk, st.nodes)
    jattrs = JA._gather_attrs(JA._pack_model(jdm), jst.nodes)
    for n_top, ratio in ((9, None), (5, 3.0)):
        got = A._next_active_attrs(dm, st, attrs, n_top, ratio).numpy()
        ref = np.asarray(JA._next_active_attrs(jdm, jst, jattrs, n_top, ratio))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(A._next_active(dm, st, n_top, ratio).numpy(), got)
