"""The port's dense forward/backward, posterior decode, transition freqs and
Q score (dbgphmm_tpu_torch.ops.forward / ops.freqs / phmm.q) against the
JAX package, in float64 on the CPU.

Mirrors tests/test_phmm_dense.py (the reference's hand-computed goldens on
the 10 bp linear mock PHMM over "ATTCGATCGT"), tests/test_freqs_history.py
(posterior freqs against a sampled History) and tests/test_freqs_q.py.
Each package builds its own model from the same inputs; every port result
is also held against the JAX function's: the same -inf cells, finite values
to 1e-9 relative (1e-12 absolute), identical map_nodes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu import ops as J
from dbgphmm_tpu.multi_dbg import MultiDbg as JMultiDbg
from dbgphmm_tpu.ops.freqs import trans_and_init_freqs as jax_freqs
from dbgphmm_tpu.phmm import model as jax_model
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.phmm import q as jax_q
from dbgphmm_tpu.seq.collection import StyledSequence as JStyled
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.ops import forward as T
from dbgphmm_tpu_torch.ops.freqs import trans_and_init_freqs
from dbgphmm_tpu_torch.phmm import PHMMParams
from dbgphmm_tpu_torch.phmm import model as port_model
from dbgphmm_tpu_torch.phmm.q import QScore, q_score_exact
from dbgphmm_tpu_torch.phmm.sample import sample_histories, sample_history
from dbgphmm_tpu_torch.seq.collection import StyledSequence

from test_torch_posterior import one_torch_thread  # noqa: F401

MOCK_SEQ = b"ATTCGATCGT"  # ref: graph/mocks.rs mock_linear
RTOL, ATOL = 1e-9, 1e-12


def close(got, ref):
    """Port result against the JAX one: -inf where it is, finite to RTOL."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL)


def pair(build, params_name, *args, dtype=torch.float64):
    """(port DeviceModel on the CPU, JAX DeviceModel), each package's model
    built by ``build`` (a function name of phmm.model) from the same
    arguments; ``params_name`` names the PHMMParams constructor (with its
    arguments)."""
    name, pargs = params_name
    pm = getattr(port_model, build)(*args, getattr(PHMMParams, name)(*pargs))
    jm = getattr(jax_model, build)(*args, getattr(jax_params.PHMMParams, name)(*pargs))
    return T.to_device(pm, "cpu", dtype), J.to_device(jm, dtype=jnp.float64), pm


def codes_of(reads):
    """(port codes, port lens, jax codes, jax lens) of the same reads."""
    codes, lens = T.pad_reads(reads)
    return (torch.as_tensor(codes), torch.as_tensor(lens), jnp.asarray(codes),
            jnp.asarray(lens))


def mock(params_name):
    return pair("linear_phmm", params_name, MOCK_SEQ)


ZERO, HIGH, DEFAULT = ("zero_error", ()), ("high_error", ()), ("default", ())


def test_forward_zero_error_golden():
    dm, jdm, _ = mock(ZERO)
    c, l, jc, jl = codes_of([b"CGATC"])
    final, tabs = T.forward_tables(dm, c, l, renorm=False)
    # ref: forward.rs:580-584
    assert float(tabs.m[2, 0, 5]) == pytest.approx(-2.3026250931, abs=1e-5)
    assert float(tabs.m[3, 0, 6]) == pytest.approx(-2.3026250931, abs=1e-5)
    assert float(tabs.m[4, 0, 7]) == pytest.approx(-2.3026350932, abs=1e-5)
    assert float(final.e[0]) == pytest.approx(-13.8155605, abs=1e-5)
    assert torch.all(tabs.i == -np.inf) and torch.all(tabs.d == -np.inf)
    jf, jt = J.forward_tables(jdm, jc, jl, renorm=False)
    for a, b in zip(tabs, jt):
        close(a, b)
    close(final.e, jf.e)
    c, l, _, _ = codes_of([b"CGATT"])
    assert float(T.forward_scores(dm, c, l, renorm=False)[0]) == -np.inf


def test_forward_high_error_golden():
    dm, jdm, _ = mock(HIGH)
    c, l, jc, jl = codes_of([b"CGATC"])
    final, tabs = T.forward_tables(dm, c, l, renorm=False)
    # ref: forward.rs:599-618
    assert float(final.e[0]) == pytest.approx(-15.212633254, abs=1e-5)
    assert float(tabs.m[4, 0, 7]) == pytest.approx(-3.8652938682, abs=1e-5)
    c2, l2, jc2, jl2 = codes_of([b"CGATT"])
    final2, tabs2 = T.forward_tables(dm, c2, l2, renorm=False)
    assert float(final2.e[0]) == pytest.approx(-16.7862972, abs=1e-5)
    assert float(tabs2.e[3, 0]) == pytest.approx(float(tabs.e[3, 0]), abs=1e-5)
    for got, (jf, jt) in ((tabs, J.forward_tables(jdm, jc, jl, renorm=False)),
                          (tabs2, J.forward_tables(jdm, jc2, jl2, renorm=False))):
        for a, b in zip(got, jt):
            close(a, b)


def test_backward_zero_error_golden():
    dm, jdm, _ = mock(ZERO)
    c, l, jc, jl = codes_of([b"CGATC"])
    final, tabs = T.backward_tables(dm, c, l, renorm=False)
    # ref: backward.rs:587-595; scan order: tabs[t] = B[len-1-t]
    assert float(final.mb[0]) == pytest.approx(-13.8155605, abs=1e-5)
    for t, node, v in ((0, 6, -11.5129354), (0, 2, -11.5129354),
                       (1, 5, -11.5129454), (1, 1, -11.5129454),
                       (2, 4, -11.5129554), (3, 3, -11.5129654),
                       (4, 2, -11.5129754)):
        assert float(tabs.m[t, 0, node]) == pytest.approx(v, abs=1e-5)
    jf, jt = J.backward_tables(jdm, jc, jl, renorm=False)
    for a, b in zip(tabs, jt):
        close(a, b)
    c, l, _, _ = codes_of([b"CGATT"])
    assert float(T.full_prob_backward(dm, c, l, renorm=False)[0]) == -np.inf


def test_backward_high_error_golden():
    dm, jdm, _ = mock(HIGH)
    c, l, jc, jl = codes_of([b"CGATC", b"CGATT"])
    final, tabs = T.backward_tables(dm, c, l, renorm=False)
    # ref: backward.rs:618-627
    assert float(tabs.m[4, 0, 2]) == pytest.approx(-13.0679200, abs=1e-5)
    assert float(final.mb[0]) == pytest.approx(-15.2115765494, abs=1e-5)
    assert float(final.mb[1]) == pytest.approx(-16.7787277, abs=1e-5)
    jf, jt = J.backward_tables(jdm, jc, jl, renorm=False)
    for a, b in zip(tabs, jt):
        close(a, b)


def test_forward_equals_backward():
    """P(x) forward ~ backward to 1e-3 (ref: tests/hmm.rs:44-56, epsilon
    0.1: the backward includes Begin->Del entries the forward excludes);
    each direction equals the JAX package's."""
    dm, jdm, _ = mock(DEFAULT)
    c, l, jc, jl = codes_of([b"CGATC", b"ATTCGATCGT", b"TTAGC"])
    pf = T.forward_scores(dm, c, l, renorm=False)
    pb = T.full_prob_backward(dm, c, l, renorm=False)
    np.testing.assert_allclose(pf.numpy(), pb.numpy(), atol=1e-3)
    close(pf, J.forward_scores(jdm, jc, jl, renorm=False))
    close(pb, J.full_prob_backward(jdm, jc, jl, renorm=False))


def test_renorm_matches_no_renorm():
    """Renormalised float64 scan == plain scan to 1e-9 (the oracle of the
    float32 path's renormalisation); both equal the JAX package's."""
    dm, jdm, _ = pair("linear_random_phmm", DEFAULT, 100, 0)
    c, l, jc, jl = codes_of([b"CGATC", b"ATTCGATCGT"])
    p1 = T.forward_scores(dm, c, l, renorm=False)
    p2 = T.forward_scores(dm, c, l, renorm=True)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=1e-9)
    close(p2, J.forward_scores(jdm, jc, jl, renorm=True))
    final, tabs = T.backward_tables(dm, c, l, renorm=True)
    jfinal, jtabs = J.backward_tables(jdm, jc, jl, renorm=True)
    for a, b in zip(tabs, jtabs):
        close(a, b)


def test_f32_close_to_f64():
    """The port in float32 (renormalised) within 1% of float64."""
    dm64, _, m = pair("linear_random_phmm", DEFAULT, 200, 0)
    dm32 = T.to_device(m, "cpu", torch.float32)
    c, l, _, _ = codes_of([MOCK_SEQ * 3])
    p64 = float(T.forward_scores(dm64, c, l, renorm=False)[0])
    p32 = float(T.forward_scores(dm32, c, l, renorm=True)[0])
    assert abs(p64 - p32) < 0.01 * abs(p64)


def test_mapping_golden():
    """Top-3 mapping nodes (ref: forward.rs:640-658 hint golden), and the
    whole decode equal to the JAX package's."""
    dm, jdm, _ = mock(HIGH)
    c, l, jc, jl = codes_of([b"CGATC"])
    logp, freqs, mn, ml = T.node_freqs_and_mappings(dm, c, l, renorm=False,
                                                    n_active=3)
    assert mn[0, :5].tolist() == [[3, 2, 4], [4, 3, 5], [5, 6, 4], [6, 7, 5],
                                  [7, 8, 6]]
    ref = J.node_freqs_and_mappings(jdm, jc, jl, renorm=False, n_active=3)
    for a, b in zip((logp, freqs, ml), (ref[0], ref[1], ref[3])):
        close(a, b)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(ref[2]))


def test_node_freqs_sum_to_length_ish():
    dm, jdm, _ = mock(DEFAULT)
    c, l, jc, jl = codes_of([MOCK_SEQ])
    _lp, freqs, _mn, _ml = T.node_freqs_and_mappings(dm, c, l, renorm=False,
                                                     n_active=3)
    assert abs(float(freqs.sum()) - len(MOCK_SEQ)) < 1.0
    close(freqs, J.node_freqs_and_mappings(jdm, jc, jl, renorm=False,
                                           n_active=3)[1])


def test_batch_consistency():
    """Batched scoring == per-read scoring (padding correctness)."""
    dm, _, _ = mock(DEFAULT)
    reads = [b"CGATC", b"ATTCGATCGT", b"AT"]
    c, l, _, _ = codes_of(reads)
    p_batch = T.forward_scores(dm, c, l, renorm=False)
    for i, r in enumerate(reads):
        c1, l1, _, _ = codes_of([r])
        p1 = T.forward_scores(dm, c1, l1, renorm=False)
        assert float(p1[0]) == pytest.approx(float(p_batch[i]), abs=1e-12)


# -- generative oracle (tests/test_freqs_history.py) ---------------------------


def test_history_basics():
    m = port_model.linear_random_phmm(100, 0, PHMMParams.default())
    h = sample_history(m, np.random.Generator(np.random.PCG64(0)),
                       max_states=500, endable=True)
    r = h.to_sequence()
    assert h.total_bases() == len(r)
    assert h.to_node_freqs(m.n_nodes).sum() >= len(r) - 5
    assert h.to_trans_counts(m).sum() <= len(h)


def test_node_freqs_match_history_linear():
    """Posterior node freqs of a sampled full-length read track its
    History; the decode equals the JAX package's."""
    dm, jdm, m = pair("linear_random_phmm", ("uniform", (0.001,)), 300, 11)
    h = sample_history(m, np.random.Generator(np.random.PCG64(7)),
                       max_states=2000, endable=False, start_node=0)
    r = h.to_sequence()
    assert len(r) > 200
    nf_true = h.to_node_freqs(m.n_nodes)
    c, l, jc, jl = codes_of([r])
    logp, freqs, _mn, _ml = T.node_freqs_and_mappings(dm, c, l, renorm=True)
    nf_est = freqs.numpy()[0][: m.n_nodes]
    assert np.isfinite(float(logp[0]))
    assert abs(nf_est.sum() - nf_true.sum()) / nf_true.sum() < 0.05
    assert np.abs(nf_est - nf_true).sum() / nf_true.sum() < 0.1
    ref = J.node_freqs_and_mappings(jdm, jc, jl, renorm=True)
    close(logp, ref[0])
    close(freqs, ref[1])
    f = T.forward_scores(dm, c, l, renorm=True)
    b = T.full_prob_backward(dm, c, l)
    assert abs(float(f[0]) - float(b[0])) < 0.1


def test_node_freqs_match_history_on_dbg():
    """The same oracle on a DBG-derived PHMM with a repeat."""
    seq = b"TTAGGCTTCGATCGAATGCCTTAGGCTTACGTAGGATCCGATA"
    params = PHMMParams.uniform(0.001)
    model = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(seq)]).to_phmm(
        params, mode="non_zero")
    jmodel = JMultiDbg.from_styled_seqs(8, [JStyled.linear(seq)]).to_phmm(
        jax_params.PHMMParams.uniform(0.001), mode="non_zero")
    rng = np.random.Generator(np.random.PCG64(3))
    nf_true = np.zeros(model.n_nodes)
    reads = []
    for _ in range(8):
        h = sample_history(model, rng, max_states=400, endable=True)
        if h.total_bases() < 10:
            continue
        nf_true += h.to_node_freqs(model.n_nodes)
        reads.append(h.to_sequence())
    c, l, jc, jl = codes_of(reads)
    _lp, freqs, mn, _ml = T.node_freqs_and_mappings(
        T.to_device(model, "cpu"), c, l, renorm=True)
    nf_est = freqs.numpy().sum(axis=0)[: model.n_nodes]
    assert abs(nf_est.sum() - nf_true.sum()) / nf_true.sum() < 0.05
    assert np.corrcoef(nf_true, nf_est)[0, 1] > 0.9
    ref = J.node_freqs_and_mappings(J.to_device(jmodel, dtype=jnp.float64),
                                    jc, jl, renorm=True)
    close(freqs, ref[1])
    np.testing.assert_array_equal(mn.numpy(), np.asarray(ref[2]))


def test_edge_freqs_match_history():
    """Expected transition usage tracks the History's transitions (ref:
    history.rs:80-100, freq.rs:276-298); equal to the JAX package's."""
    dm, jdm, m = pair("linear_random_phmm", ("uniform", (0.001,)), 200, 5)
    h = sample_history(m, np.random.Generator(np.random.PCG64(9)),
                       max_states=1200, endable=False, start_node=0)
    tc_true = h.to_trans_counts(m)
    c, l, jc, jl = codes_of([h.to_sequence()])
    trans, init, logp = trans_and_init_freqs(dm, c, l)
    tc_est = trans.numpy()[0][: tc_true.shape[0], : tc_true.shape[1]]
    assert abs(tc_est.sum() - tc_true.sum()) / max(tc_true.sum(), 1) < 0.05
    assert np.abs(tc_est - tc_true).sum() / max(tc_true.sum(), 1) < 0.1
    for a, b in zip((trans, init, logp), jax_freqs(jdm, jc, jl)):
        close(a, b)


def test_sample_histories_deterministic():
    m = port_model.linear_random_phmm(80, 2, PHMMParams.default())
    a = sample_histories(m, 3, 200, seed=5)
    assert [h.steps for h in a] == [h.steps for h in sample_histories(m, 3, 200, seed=5)]
    assert [h.steps for h in a] != [h.steps for h in sample_histories(m, 3, 200, seed=6)]


# -- transition freqs and the Q score (tests/test_freqs_q.py) ------------------


def test_edge_freqs_linear_zero_error():
    """An error-free full-length read on a chain: every chain transition
    used once, init mass 1 at node 0."""
    dm, jdm, _ = mock(ZERO)
    c, l, jc, jl = codes_of([MOCK_SEQ])
    sf, inf, logp = trans_and_init_freqs(dm, c, l, renorm=False)
    n = len(MOCK_SEQ)
    np.testing.assert_allclose(sf.numpy()[0][: n - 1, 0], 1.0, atol=1e-6)
    assert float(inf[0, 0]) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(inf.numpy()[0][1:n], 0.0, atol=1e-6)
    for a, b in zip((sf, inf, logp), jax_freqs(jdm, jc, jl, renorm=False)):
        close(a, b)


def test_edge_freqs_partial_read():
    dm, jdm, _ = mock(DEFAULT)
    c, l, jc, jl = codes_of([MOCK_SEQ[3:8]])
    sf, inf, logp = trans_and_init_freqs(dm, c, l, renorm=False)
    sf, inf_np = sf.numpy()[0], inf.numpy()[0]
    np.testing.assert_allclose(sf[3:7, 0], 1.0, atol=0.05)
    assert sf[0, 0] < 1e-3
    assert inf_np[3] == pytest.approx(1.0, abs=0.05)
    jsf, jinf, _ = jax_freqs(jdm, jc, jl, renorm=False)
    close(sf, np.asarray(jsf)[0])
    close(inf, jinf)


def test_q_score():
    """q_score_exact on the port's freqs: finite, init ~ n_reads, chain
    trans ~ 0; the same QScore as the JAX package's."""
    dm, jdm, model = mock(DEFAULT)
    c, l, jc, jl = codes_of([MOCK_SEQ, MOCK_SEQ[2:9]])
    sf, inf, _lp = trans_and_init_freqs(dm, c, l, renorm=False)
    sf, inf = sf.numpy().sum(axis=0), inf.numpy().sum(axis=0)
    q = q_score_exact(model, sf, inf)
    assert np.isfinite(q.total())
    assert inf.sum() == pytest.approx(2.0, abs=0.05)
    assert q.trans == pytest.approx(0.0, abs=1e-6)
    assert q.sub(QScore(0.0, 0.0, 0.0)).total() == pytest.approx(q.total())
    jsf, jinf, _ = jax_freqs(jdm, jc, jl, renorm=False)
    jq = jax_q.q_score_exact(jax_model.linear_phmm(
        MOCK_SEQ, jax_params.PHMMParams.default()),
        np.asarray(jsf).sum(axis=0), np.asarray(jinf).sum(axis=0))
    assert q.init == pytest.approx(jq.init, rel=RTOL, abs=ATOL)
    assert q.trans == pytest.approx(jq.trans, rel=RTOL, abs=ATOL)
