"""The K1, K2 and K3 CUDA kernels against their plain PyTorch twins, on an
NVIDIA GPU.

Every test here needs a card and skips without one.  This file imports
nothing of JAX or of the JAX package, so it runs on a machine that has only
PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dbgphmm_tpu_torch.e2e import ReadType, generate_dataset
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import posterior as TP
from dbgphmm_tpu_torch.multi_dbg.seed import seed_mappings_arrays
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.phmm.template import make_template
from dbgphmm_tpu_torch.seq import genome as G
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops.forward import pad_reads
from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def synthetic_streams(A, D, NC, C, B, L, seed):
    """Structurally valid random streams (slot ids in [-1, A), compact ids
    in [0, NC), ~20% empty slots) and random eff tables."""
    rng = np.random.default_rng(seed)
    emis = rng.integers(0, 4, (L, B, A))
    emis[rng.random((L, B, A)) < 0.2] = 9
    eff = rng.integers(0, 4, (C, NC)).astype(np.float32)
    eff[:, NC - 1] = 0.0
    return dict(
        eff=eff,
        linv=-np.log(rng.integers(100, 1000, C).astype(np.float64)),
        lens=rng.integers(L // 2, L + 1, B), codes=rng.integers(0, 4, (L, B)),
        emis=emis, numce=rng.integers(0, NC - 1, (L, B, A)),
        selfp=rng.integers(-1, A, (L, B, A)),
        prevp=rng.integers(-1, A, (L, D, B, A)),
        curp=rng.integers(-1, A, (L, D, B, A)),
        dence=rng.integers(0, NC, (L, D, B, A)),
    )


def run_k1(s, device, dtype, fn=T.mapped_scores_log, inv="linv", **kw):
    """Run ``fn`` on the case; K3 takes ``inv="inv_total"`` (linear)."""
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                    device=device)
    lt = T.lin_params(PHMMParams.uniform(0.001), np.float64)
    inv_v = s["linv"] if inv == "linv" else np.exp(s["linv"])
    return fn(
        torch.as_tensor(s["eff"], dtype=dtype, device=device),
        torch.as_tensor(inv_v, dtype=dtype, device=device),
        *[i32(s[k]) for k in ("lens", "codes", "emis", "numce", "selfp",
                              "prevp", "curp", "dence")],
        torch.as_tensor(lt, dtype=dtype, device=device), **kw,
    ).cpu().double().numpy()


@pytest.mark.parametrize("A,D,NC", [(16, 2, 128), (32, 3, 256), (64, 3, 384),
                                    (128, 3, 256)])
def test_kernel_matches_twin(cuda, A, D, NC):
    """Per read: |kernel - f64 twin| <= 1e-5 |ref| + 0.05 (float32 over the
    read), the float32 twin to 1e-3; every candidate group size agrees,
    including a partial last group (21 candidates)."""
    s = synthetic_streams(A, D, NC, C=21, B=12, L=300, seed=A)
    launches = T.mapped_scores_log.launches
    got = run_k1(s, cuda, torch.float32)
    assert T.mapped_scores_log.launches == launches + 1
    ref = run_k1(s, cuda, torch.float64, fn=T.mapped_scores_log_reference)
    ref32 = run_k1(s, cuda, torch.float32, fn=T.mapped_scores_log_reference)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert (np.abs(got[fin] - ref[fin]) <= 1e-5 * np.abs(ref[fin]) + 0.05).all()
    np.testing.assert_allclose(got[fin], ref32[fin], rtol=0, atol=1e-3)
    for g in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            run_k1(s, cuda, torch.float32, group=g), got)


@pytest.mark.parametrize("A,D,NC", [(16, 4, 128), (32, 4, 256), (64, 3, 384),
                                    (128, 3, 256)])
def test_kernel_matches_twin_sparse_columns(cuda, A, D, NC):
    """K1 and K2 where, as on a de Bruijn graph, most positions have one
    parent per slot and one out-edge per source node (the kernels' shortcut
    that skips negligible log-sum-exp terms), with a few branch positions;
    eff columns past n_live are 0 and the wrappers stage only n_live.
    Tolerances as in test_kernel_matches_twin; the forced groups agree bit
    for bit."""
    s = synthetic_streams(A, D, NC, C=21, B=12, L=300, seed=A + 3)
    rng = np.random.default_rng(A)
    branch = rng.random((300, 1, 12, A)) < 0.05
    for k in ("prevp", "curp"):
        s[k][:, 1:] = np.where(branch, s[k][:, 1:], -1)
    s["dence"][:, 1:] = np.where(branch, s["dence"][:, 1:], NC - 1)
    s["dence"][:, 0] = np.where(branch[:, 0], s["dence"][:, 0], s["numce"])
    n_live = NC // 2
    s["numce"] %= n_live
    s["dence"] = np.where(s["dence"] == NC - 1, NC - 1, s["dence"] % n_live)
    s["eff"][:, n_live:] = 0.0
    assert T.live_columns(torch.as_tensor(s["eff"], device=cuda)) == n_live
    for fn, twin in ((T.mapped_scores_log, T.mapped_scores_log_reference),
                     (T.mapped_scores_log_single,
                      T.mapped_scores_log_single_reference)):
        got = run_k1(s, cuda, torch.float32, fn=fn)
        ref = run_k1(s, cuda, torch.float64, fn=twin)
        ref32 = run_k1(s, cuda, torch.float32, fn=twin)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        fin = np.isfinite(ref)
        assert fin.any()
        assert (np.abs(got[fin] - ref[fin])
                <= 1e-5 * np.abs(ref[fin]) + 0.05).all()
        np.testing.assert_allclose(got[fin], ref32[fin], rtol=0, atol=1e-3)
    for g in (1, 8):
        np.testing.assert_array_equal(
            run_k1(s, cuda, torch.float32, group=g),
            run_k1(s, cuda, torch.float32))


def test_log_kernels_refuse_a_nonzero_sentinel_column(cuda):
    """K1 and K2 stage eff up to its last non-zero column; the sentinel
    column NC - 1 (the id of an empty slot or a missing out-edge) must be
    0, and a table where it is not is refused before any launch."""
    s = synthetic_streams(32, 3, 256, C=5, B=4, L=50, seed=7)
    s["eff"][2, 255] = 1.0
    for fn in (T.mapped_scores_log, T.mapped_scores_log_single):
        launches = fn.launches
        with pytest.raises(ValueError, match="sentinel"):
            run_k1(s, cuda, torch.float32, fn=fn)
        assert fn.launches == launches


def blocked_case(A, D, NC, seed):
    """21 candidates (not a multiple of 8).  Positions 100-199 map only to
    the lower half of the compact edges, which the last candidate zeroes:
    there its reads live on only in I states and the Begin chain, low but
    finite in log space, underflowing in linear space."""
    s = synthetic_streams(A, D, NC, C=21, B=12, L=300, seed=seed)
    s["numce"][100:200] %= NC // 2
    s["eff"][-1, : NC // 2] = 0.0
    return s


@pytest.mark.parametrize("A,D,NC", [(16, 2, 128), (32, 3, 256), (64, 3, 384),
                                    (128, 3, 256)])
def test_k2_matches_twin(cuda, A, D, NC):
    """K2 against its float64 twin per read (1e-5 |ref| + 0.05 nats), -inf
    exactly where the twin has it, the float32 twin to 1e-3."""
    s = blocked_case(A, D, NC, seed=A + 1)
    fn, twin = T.mapped_scores_log_single, T.mapped_scores_log_single_reference
    launches = fn.launches
    got = run_k1(s, cuda, torch.float32, fn=fn)
    assert fn.launches == launches + 1
    ref = run_k1(s, cuda, torch.float64, fn=twin)
    ref32 = run_k1(s, cuda, torch.float32, fn=twin)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(ref[-1]).any()
    fin = np.isfinite(ref)
    assert (np.abs(got[fin] - ref[fin]) <= 1e-5 * np.abs(ref[fin]) + 0.05).all()
    np.testing.assert_allclose(got[fin], ref32[fin], rtol=0, atol=1e-3)


@pytest.mark.parametrize("A,D,NC", [(16, 2, 128), (32, 3, 256), (64, 3, 384),
                                    (128, 3, 256)])
def test_k3_matches_twin(cuda, A, D, NC):
    """K3 against its twins: the float32 twin with the same -inf pattern
    and values to 1e-3; the float64 twin to 1e-5 |ref| + 0.05 nats where
    the kernel is finite, and every read that is -inf in float64 is -inf in
    the kernel (float32 underflows earlier, so not the converse).  One and
    eight candidates per block agree bit for bit (a partial last group)."""
    s = blocked_case(A, D, NC, seed=A + 2)
    fn, twin = T.mapped_scores_linear, T.mapped_scores_linear_reference
    launches = fn.launches
    got = run_k1(s, cuda, torch.float32, fn=fn, inv="inv_total")
    assert fn.launches == launches + 1
    ref = run_k1(s, cuda, torch.float64, fn=twin, inv="inv_total")
    ref32 = run_k1(s, cuda, torch.float32, fn=twin, inv="inv_total")
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref32))
    assert not np.isnan(got).any()
    assert np.isneginf(got[np.isneginf(ref)]).all()
    assert np.isneginf(got[-1]).any()
    fin = np.isfinite(got)
    assert (np.abs(got[fin] - ref[fin]) <= 1e-5 * np.abs(ref[fin]) + 0.05).all()
    np.testing.assert_allclose(got[fin], ref32[fin], rtol=0, atol=1e-3)
    for g in (1, 8):
        np.testing.assert_array_equal(
            run_k1(s, cuda, torch.float32, fn=fn, inv="inv_total", group=g),
            got)


def test_kernel_rejects_bad_inputs(cuda):
    s = synthetic_streams(32, 3, 256, C=4, B=8, L=40, seed=1)
    for fn in (T.mapped_scores_log, T.mapped_scores_log_single,
               T.mapped_scores_linear):
        with pytest.raises(ValueError, match="float32"):
            run_k1(s, cuda, torch.float64, fn=fn)


def test_seeded_scorer_on_gpu_matches_cpu(cuda):
    """Seeded mappings refined on the GPU (float32) and on the CPU (float64)
    agree, and MappedScorer on the GPU (the kernel) matches the CPU (the
    float64 twin) in each space on the k=16 tandem-repeat fixture."""
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0)
    ds = generate_dataset(g, 0, 6, 200, ReadType.FIXED_SIZE_FRAGMENT,
                          PHMMParams.uniform(0.005))
    dbg = MultiDbg.from_styled_seqs(16, list(g))
    reads = list(ds.reads)[:12]
    params = PHMMParams.uniform(0.005)
    seeds = seed_mappings_arrays(dbg, reads)
    hint = TP.Mappings(seeds, [np.zeros(a.shape) for a in seeds], None, None, -1)
    maps = {dev: TP.generate_mappings(dbg, params, reads, dev, hint=hint,
                                      hint_regen=False)
            for dev in ("cpu", "cuda")}
    np.testing.assert_allclose(maps["cuda"].read_logps, maps["cpu"].read_logps,
                               rtol=1e-4)
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps["cpu"], codes.shape[1], 32)
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    cands = [dbg.get_copy_nums(), [1] * dbg.n_edges_compact()]
    for space in T.SPACES:
        per = {dev: T.MappedScorer(tpl, pos, codes, lens, params, dev,
                                   space=space).per_read(cands)
               for dev in ("cpu", "cuda")}
        fin = np.isfinite(per["cuda"])
        if space != "linear":  # float32 linear may underflow where f64 does not
            np.testing.assert_array_equal(np.isfinite(per["cpu"]), fin)
        assert (np.abs(per["cuda"] - per["cpu"])[fin]
                <= 1e-5 * np.abs(per["cpu"][fin]) + 0.05).all(), space
