"""The K1, K2 and K3 CUDA kernels and the refine's R1 and R2 against
their plain PyTorch versions, on an NVIDIA GPU.

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
from dbgphmm_tpu_torch.ops import adaptive as AD
from dbgphmm_tpu_torch.ops import mapped_scorer as T
from dbgphmm_tpu_torch.ops.forward import DeviceModel, _log_trans, pad_reads
from dbgphmm_tpu_torch.ops.sparse import pad_mappings, precompute_positions

pytestmark = pytest.mark.cuda
GROUPS = tuple(1 << i for i in range(T.MAX_ROWS.bit_length()))  # 1 .. 8


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
    for g in GROUPS:
        np.testing.assert_array_equal(
            run_k1(s, cuda, torch.float32, group=g), got)


def sparse_case(A, D, NC):
    """21 candidates where, as on a de Bruijn graph, most positions have
    one parent per slot and one out-edge per source node (the kernels'
    per-position specialisation on live_degree_columns, and K1 / K2's
    shortcut that skips negligible log-sum-exp terms), with a few branch
    positions; eff columns past n_live = NC / 2 are 0 and the wrappers
    stage only n_live."""
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
    return s


@pytest.mark.parametrize("A,D,NC", [(16, 4, 128), (32, 4, 256), (64, 3, 384),
                                    (128, 3, 256)])
def test_kernel_matches_twin_sparse_columns(cuda, A, D, NC):
    """K1, K2 and K3 on the sparse-column case.  K1 and K2: tolerances as
    in test_kernel_matches_twin.  K3: the float32 twin's -inf pattern and
    values to 1e-3, the float64 twin to 1e-5 |ref| + 0.05 nats where the
    kernel is finite.  Every forced group agrees bit for bit: K1 at 1 and
    8 rows per block, K2 at 1, 2, 4 and 8, K3 at 1 and 8."""
    s = sparse_case(A, D, NC)
    assert T.live_columns(torch.as_tensor(s["eff"], device=cuda)) == NC // 2
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
    lin = dict(fn=T.mapped_scores_linear, inv="inv_total")
    got = run_k1(s, cuda, torch.float32, **lin)
    ref = run_k1(s, cuda, torch.float64, fn=T.mapped_scores_linear_reference,
                 inv="inv_total")
    ref32 = run_k1(s, cuda, torch.float32, fn=T.mapped_scores_linear_reference,
                   inv="inv_total")
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref32))
    assert np.isneginf(got[np.isneginf(ref)]).all()
    fin = np.isfinite(got)
    assert fin.any()
    assert (np.abs(got[fin] - ref[fin]) <= 1e-5 * np.abs(ref[fin]) + 0.05).all()
    np.testing.assert_allclose(got[fin], ref32[fin], rtol=0, atol=1e-3)
    for fn, groups in ((T.mapped_scores_log, (1, T.MAX_ROWS)),
                       (T.mapped_scores_log_single, GROUPS),
                       (T.mapped_scores_linear, (1, T.MAX_ROWS))):
        inv = "inv_total" if fn is T.mapped_scores_linear else "linv"
        picked = run_k1(s, cuda, torch.float32, fn=fn, inv=inv)
        for g in groups:
            np.testing.assert_array_equal(
                run_k1(s, cuda, torch.float32, fn=fn, inv=inv, group=g),
                picked)


def test_log_kernels_refuse_a_nonzero_sentinel_column(cuda):
    """K1, K2 and K3 stage eff up to its last non-zero column; the sentinel
    column NC - 1 (the id of an empty slot or a missing out-edge) must be
    0, and a table where it is not is refused before any launch."""
    s = synthetic_streams(32, 3, 256, C=5, B=4, L=50, seed=7)
    s["eff"][2, 255] = 1.0
    for fn in (T.mapped_scores_log, T.mapped_scores_log_single,
               T.mapped_scores_linear):
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
    exactly where the twin has it, the float32 twin to 1e-3; 1, 2, 4 and 8
    candidates per block agree bit for bit (a partial last group)."""
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
    for g in GROUPS:
        np.testing.assert_array_equal(run_k1(s, cuda, torch.float32, fn=fn,
                                             group=g), got)


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
    for g in (1, T.MAX_ROWS):
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


def test_sharded_paths_on_one_card_match_unsharded(cuda):
    """On a mesh whose shards all name the one card: MappedScorer over a
    2x2 mesh launches each kernel once per shard and returns the unsharded
    scores (the kernel gate at most, equality expected), and the refine
    over a 1x2 mesh returns the unsharded mappings (1e-6 relative)."""
    from dbgphmm_tpu_torch.parallel import make_mesh

    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0)
    ds = generate_dataset(g, 0, 6, 200, ReadType.FIXED_SIZE_FRAGMENT,
                          PHMMParams.uniform(0.005))
    dbg = MultiDbg.from_styled_seqs(16, list(g))
    reads = list(ds.reads)[:12]
    params = PHMMParams.uniform(0.005)
    seeds = seed_mappings_arrays(dbg, reads)
    hint = TP.Mappings(seeds, [np.zeros(a.shape) for a in seeds], None, None, -1)
    maps = [TP.generate_mappings(dbg, params, reads, cuda, hint=hint,
                                 hint_regen=False, mesh=mesh)
            for mesh in (None, make_mesh(2, devices=[cuda] * 2))]
    np.testing.assert_allclose(maps[1].read_logps, maps[0].read_logps,
                               rtol=1e-6)
    codes, lens = pad_reads(reads)
    tpl = make_template(dbg, params)
    mn = pad_mappings(maps[0], codes.shape[1], 32)
    pos = precompute_positions(mn, tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    cands = [dbg.get_copy_nums(), [1] * dbg.n_edges_compact()] * 3
    mesh = make_mesh(4, cand_axis=2, devices=[cuda] * 4)
    for space, wrapper in zip(T.SPACES, (T.mapped_scores_log,
                                         T.mapped_scores_log_single,
                                         T.mapped_scores_linear)):
        local = T.MappedScorer(tpl, pos, codes, lens, params, cuda,
                               space=space).per_read(cands)
        sharded = T.MappedScorer(tpl, pos, codes, lens, params, cuda,
                                 space=space, mesh=mesh)
        n0 = wrapper.launches
        got = sharded.per_read(cands)
        assert wrapper.launches - n0 == sum(2 for b in sharded.blocks if b[3])
        fin = np.isfinite(local)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert (np.abs(got - local)[fin]
                <= 1e-5 * np.abs(local[fin]) + 0.05).all(), space


# -- the refine's scans R1 and R2 ---------------------------------------------


def random_refine_case(n, D, B, L, A, dtype, seed, device="cpu", n_max_gaps=4):
    """A random model (n nodes, D parent / child columns, about half of them
    -inf), reads of unequal lengths (read 0 full, the rest 0..L bases) and
    a hint [B, L, A] of random nodes with ~30% -1 slots (duplicates
    included): (DeviceModel, codes, lens, hint) on ``device``."""
    rng = np.random.default_rng(seed)

    def logs(shape, p_neg):
        v = np.log(rng.random(shape) * 0.9 + 0.05)
        v[rng.random(shape) < p_neg] = -np.inf
        return v

    f = lambda a: torch.tensor(a, dtype=dtype, device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, dtype=np.int32), device=device)
    lt = np.log([0.9, 0.8, 0.7, 0.05, 0.15, 0.1, 0.05, 0.05, 0.2, 0.99,
                 0.003, 0.25, 0.5])
    dm = DeviceModel(
        emission=i32(rng.integers(0, 5, n)), init_logp=f(logs(n, 0.3)),
        parent_idx=i32(rng.integers(0, n, (n, D))),
        parent_logt=f(logs((n, D), 0.5)),
        child_idx=i32(rng.integers(0, n, (n, D))),
        child_logt=f(logs((n, D), 0.5)),
        lt=_log_trans(lt, device, dtype), n_max_gaps=n_max_gaps)
    lens = rng.integers(0, L + 1, B)
    lens[0] = L
    codes = rng.integers(0, 4, (B, L))
    codes[np.arange(L)[None, :] >= lens[:, None]] = -1
    hint = rng.integers(0, n, (B, L, A))
    hint[rng.random((B, L, A)) < 0.3] = -1
    return dm, i32(codes), i32(lens), i32(hint)


def rel_err(got, ref, scale=None):
    """max |got - ref| / max(|ref|, scale, 1) over the finite entries, after
    asserting the same -inf / +inf pattern.  A decode's log posterior is
    (F + B + offsets) - log P(read): its rounding is that of terms as large
    as the read's log-likelihood, so ``scale`` is |e| of its read there."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all()
    if not fin.any():
        return 0.0
    den = np.maximum(np.abs(ref), 1.0)
    if scale is not None:
        s = np.abs(scale.double().cpu().numpy()).reshape(
            scale.shape + (1,) * (ref.ndim - scale.ndim))
        den = np.maximum(den, np.where(np.isfinite(s), s, 1.0))
    return float(np.max(np.abs(got[fin] - ref[fin]) / den[fin]))


REFINE_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("A,D", [(16, 2), (64, 3), (256, 4)])
def test_refine_kernels_match_plain(cuda, A, D, dtype):
    """R1 and R2 against their plain versions on the card: stored node ids
    equal; m / i / d, off, e and the decode's map_logp to 1e-9 (float64) or
    1e-5 (float32) relative (to max(|x|, 1); map_logp to max(|x|, |e|, 1)
    of its read, see rel_err), with the same -inf pattern;
    >= 99.9% equal top-1 nodes; one launch each."""
    dm, codes, lens, hint = random_refine_case(4 * A, D, 6, 120, A, dtype,
                                                seed=A + D, device=cuda)
    n1, n2 = AD.forward_mapped_tables.launches, AD.decode_from_forward.launches
    got = AD.forward_mapped_tables(dm, codes, lens, hint)
    ref = AD.forward_mapped_tables_reference(dm, codes, lens, hint)
    assert AD.forward_mapped_tables.launches == n1 + 1
    assert torch.equal(got.nodes, ref.nodes)
    tol = REFINE_TOL[dtype]
    for name in ("m", "i", "d", "off", "e"):
        assert rel_err(getattr(got, name), getattr(ref, name)) <= tol, name
    for ratio in (None, 10.0):
        lp, mn, ml = AD.decode_from_forward(dm, codes, lens, ref, 40, ratio)
        lp_r, mn_r, ml_r = AD.decode_from_forward_reference(dm, codes, lens,
                                                            ref, 40, ratio)
        assert rel_err(ml, ml_r, lp_r) <= tol
        assert torch.equal(lp, lp_r)
        assert (mn[..., 0] == mn_r[..., 0]).double().mean() >= 0.999
    assert AD.decode_from_forward.launches == n2 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_kernel_on_bf16_adaptive_tables(cuda, dtype):
    """R2 on the sparse-adaptive forward's bfloat16 tables: 300 stored
    cells (two per thread) and 64; the plain version's tolerance, map_logp
    relative to max(|x|, |e|, 1) of its read."""
    dm, codes, lens, _hint = random_refine_case(600, 3, 5, 80, 8, dtype,
                                                 seed=7, device=cuda)
    for stored_k in (None, 64):
        f = AD.forward_sparse_adaptive(dm, codes, lens, n_top=100,
                                       n_warmup=4, max_ratio=10.0,
                                       stored_k=stored_k, store_bf16=True)
        assert f.m.dtype == torch.bfloat16
        got = AD.decode_from_forward(dm, codes, lens, f, 128, 10.0)
        ref = AD.decode_from_forward_reference(dm, codes, lens, f, 128, 10.0)
        assert rel_err(got[2], ref[2], ref[0]) <= REFINE_TOL[dtype]
        assert (got[1][..., 0] == ref[1][..., 0]).double().mean() >= 0.999


def test_refine_kernels_refuse_bad_inputs(cuda):
    """A hint wider than 256 slots, an int64 or a non-contiguous hint, a
    float16 model, more than 512 stored cells: ValueError, no launch."""
    dm, codes, lens, hint = random_refine_case(64, 3, 2, 20, 16,
                                                torch.float32, seed=1,
                                                device=cuda)
    n1, n2 = AD.forward_mapped_tables.launches, AD.decode_from_forward.launches
    wide = torch.zeros((2, 20, 257), dtype=torch.int32, device=cuda)
    for bad, what in ((wide, "width"), (hint.long(), "int64"),
                      (hint.transpose(0, 1).contiguous().transpose(0, 1),
                       "contiguous")):
        with pytest.raises(ValueError, match=what):
            AD.forward_mapped_tables(dm, codes, lens, bad)
    import dataclasses
    half = dataclasses.replace(dm, init_logp=dm.init_logp.half())
    with pytest.raises(ValueError, match="float16"):
        AD.forward_mapped_tables(half, codes, lens, hint)
    f = AD.forward_mapped_tables_reference(dm, codes, lens, hint)
    big = f._replace(**{k: torch.cat([getattr(f, k)] * 33, dim=2)
                        for k in ("nodes", "m", "i", "d")})
    with pytest.raises(ValueError, match="width 528"):
        AD.decode_from_forward(dm, codes, lens, big, 40, None)
    assert AD.forward_mapped_tables.launches == n1
    assert AD.decode_from_forward.launches == n2


# A1 / A2 cases: (n, D, n_top, forward_sparse_adaptive's other arguments);
# n_warmup None = the read length (the dense-compute regime, A1 alone)
ADAPTIVE_CASES = {
    "dense_a_below_n": (600, 3, 40, dict(n_warmup=None)),
    "dense_a_is_n": (100, 3, 40, dict(n_warmup=None, max_ratio=10.0)),
    "dense_d4": (300, 4, 30, dict(n_warmup=None)),
    "frontier_ratio": (600, 3, 40, dict(n_warmup=4, max_ratio=10.0)),
    "frontier_stored_bf16": (600, 3, 100, dict(n_warmup=4, max_ratio=10.0,
                                               stored_k=64, store_bf16=True)),
    "frontier_d5_no_gaps": (400, 5, 20, dict(n_warmup=3)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_kernels_match_plain(cuda, case, dtype):
    """A1 (and A2 past the warm-up) against forward_sparse_adaptive_reference
    on the card, reads of unequal lengths (one empty): the stored nodes and
    the -inf patterns equal; m / i / d and off bit for bit in float32
    (bfloat16 rows too) and to 1e-9 relative in float64, e to 1e-5 (float32:
    a log-sum-exp over n summed in another order) or 1e-9; one launch of
    each kernel and no plain run by the wrapper."""
    n, D, n_top, kw = ADAPTIVE_CASES[case]
    gaps = 0 if case == "frontier_d5_no_gaps" else 3
    dm, codes, lens, _hint = random_refine_case(n, D, 6, 60, 8, dtype,
                                                 seed=n + D, device=cuda,
                                                 n_max_gaps=gaps)
    lens[1] = 0
    kw = dict(kw, n_top=n_top)
    if kw["n_warmup"] is None:
        kw["n_warmup"] = int(codes.shape[1])
    frontier = kw["n_warmup"] < codes.shape[1]
    n1, n2 = AD.adaptive_dense.launches, AD.adaptive_frontier.launches
    calls = AD.forward_sparse_adaptive_reference.calls
    got = AD.forward_sparse_adaptive(dm, codes, lens, **kw)
    assert AD.forward_sparse_adaptive_reference.calls == calls
    assert (AD.adaptive_dense.launches - n1,
            AD.adaptive_frontier.launches - n2) == (1, int(frontier))
    ref = AD.forward_sparse_adaptive_reference(dm, codes, lens, **kw)
    assert torch.equal(got.nodes, ref.nodes)
    tol = REFINE_TOL[dtype]
    for name in ("m", "i", "d", "off", "e"):
        assert rel_err(getattr(got, name), getattr(ref, name)) <= tol, name
        if dtype == torch.float32 and name != "e":
            assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_adaptive_kernels_refuse_bad_inputs(cuda):
    """More than 512 carried cells, int64 codes, a float16 model, a degree
    above 5: ValueError, no launch."""
    import dataclasses

    dm, codes, lens, _hint = random_refine_case(900, 3, 2, 20, 8,
                                                 torch.float32, seed=1,
                                                 device=cuda)
    n1, n2 = AD.adaptive_dense.launches, AD.adaptive_frontier.launches
    with pytest.raises(ValueError, match="width 520"):
        AD.forward_sparse_adaptive(dm, codes, lens, n_top=130)
    with pytest.raises(ValueError, match="int64"):
        AD.forward_sparse_adaptive(dm, codes.long(), lens, n_top=40)
    half = dataclasses.replace(dm, init_logp=dm.init_logp.half())
    with pytest.raises(ValueError, match="float16"):
        AD.forward_sparse_adaptive(half, codes, lens, n_top=40)
    wide, _c, _l, _h = random_refine_case(900, 6, 2, 20, 8, torch.float32,
                                          seed=1, device=cuda)
    with pytest.raises(ValueError, match="degree"):
        AD.forward_sparse_adaptive(wide, codes, lens, n_top=40)
    assert (AD.adaptive_dense.launches, AD.adaptive_frontier.launches) == (n1, n2)
