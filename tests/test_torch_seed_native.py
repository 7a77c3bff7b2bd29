"""The native seeder (``seed_read_native`` over ``csrc/host/seedchain.cpp``)
against the pure-Python seeder (``seed_read``) of the port's copy of the
JAX package's seeder, ``dbgphmm_tpu_torch.multi_dbg.seed``.  Every k-stage
of the port's main path starts from it.

The two keep the same candidate set at every position where neither reaches
the union width cap ``UNION_WIDTH``.  At the cap they may keep different
members of a tie, so there only the width is compared.  The order within a
set may differ (the union is a set).

The native candidate block (``dbg_seed_backfill_rows``: the backfill and
the [L, W] fill behind ``seed_mappings_arrays``) is held bit for bit to the
same steps in Python over the native chain DP's rows: unpacking,
``_backfill``, the row-by-row fill.
"""

from pathlib import Path

import numpy as np
import pytest

from dbgphmm_tpu_torch import tracing
from dbgphmm_tpu_torch.e2e import Dataset, ReadType, generate_dataset
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import output as out
from dbgphmm_tpu_torch.multi_dbg import seed as S
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.seq import genome as G

BENCH = Path(__file__).resolve().parent.parent / "data" / "bench"


@pytest.fixture(scope="module")
def native():
    if S._seed_lib() is None:
        pytest.skip("the g++-built seeder library (csrc/host/seedchain.cpp) "
                    "did not load")


def _assert_same_sets(idx, reads):
    n_checked = n_capped = 0
    for r in reads:
        rb = bytes(r)
        py = S.seed_read(idx, rb)
        nat = S.seed_read_native(idx, rb)
        assert len(py) == len(nat) == len(rb)
        for i, (a, b) in enumerate(zip(py, nat)):
            if max(len(a), len(b)) >= S.UNION_WIDTH:
                assert len(a) == len(b), (i, len(a), len(b))
                n_capped += 1
                continue
            np.testing.assert_array_equal(np.sort(a), np.sort(b),
                                          err_msg=f"position {i}")
            n_checked += 1
    return n_checked, n_capped


def test_native_seeder_matches_python_on_the_bench_draft(native):
    """Three reads of the committed k=40 draft's dataset at full length
    (~10 kb each)."""
    ds = Dataset.from_json_file(BENCH / "data.json")
    dbg = out.from_dbg_file(BENCH / "data.dbg")
    idx = S.SeedIndex(dbg, S.SEED_S)
    n_checked, n_capped = _assert_same_sets(idx, list(ds.reads)[:3])
    assert n_checked > 0.99 * (n_checked + n_capped)


def test_native_seeder_matches_python_on_a_synthetic_graph(native):
    """A k=16 diploid tandem repeat (branching graph) and error-bearing
    fragment reads sampled from it."""
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0)
    ds = generate_dataset(g, 0, 6, 200, ReadType.FIXED_SIZE_FRAGMENT,
                          PHMMParams.uniform(0.01))
    dbg = MultiDbg.from_styled_seqs(16, list(g))
    idx = S.SeedIndex(dbg, S.SEED_S)
    n_checked, _n_capped = _assert_same_sets(idx, list(ds.reads)[:12])
    assert n_checked > 0


# -- the native candidate block ------------------------------------------------


@pytest.fixture(scope="module")
def graphs(native):
    """Per graph: its SeedIndex and a clean read to cut and splice."""
    ds = Dataset.from_json_file(BENCH / "data.json")
    bench = out.from_dbg_file(BENCH / "data.dbg")
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0)
    frags = generate_dataset(g, 0, 6, 200, ReadType.FIXED_SIZE_FRAGMENT,
                             PHMMParams.uniform(0.01))
    k16 = MultiDbg.from_styled_seqs(16, list(g))
    bench_reads = [bytes(r) for r in ds.reads]
    return {
        # reads 61 and 80 of the set end in, and hold inside, rows that
        # neither chain pass reaches (errors before the read's last seed)
        "bench": (bench, S.SeedIndex(bench, S.SEED_S),
                  [bench_reads[61], bench_reads[80]], bench_reads[0][:1500]),
        "k16": (k16, S.SeedIndex(k16, S.SEED_S),
                [bytes(r) for r in frags.reads][:6], bytes(frags.reads[0])),
    }


def _junk(n: int, seed: int) -> bytes:
    # a seed of its own: the genomes are drawn from small seeds
    rng = np.random.default_rng([915_337, seed])
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


def _reads_of(kind: str, real, clean: bytes):
    h = len(clean) // 2
    return {
        "reads": real,
        "junk_head": [_junk(40, 1) + clean],  # the backward sweep
        "junk_inside": [clean[:h] + _junk(60, 2) + clean[h:]],  # forward
        "no_hit": [_junk(300, 3)],  # all -1, W = 1, reads_unseeded
    }[kind]


def _reference(idx, rb: bytes):
    """The candidate block as the port's Python built it from the native
    chain DP's rows: its empty rows before and after ``_backfill``, the
    block and its non-empty rows."""
    L = len(rb)
    hits = S._read_hits(idx, rb)
    if not hits:
        return L, L, np.full((L, 1), -1, dtype=np.int32), 0
    union = np.empty((L, S.UNION_WIDTH), dtype=np.int64)
    S._chain_union(S._seed_lib(), idx, np.frombuffer(rb, np.uint8), hits,
                   union)
    rows = [row[row >= 0] for row in union]
    empty_before = sum(len(x) == 0 for x in rows)
    rows = S._backfill(idx, rows)
    W = max(1, max(len(x) for x in rows))
    a = np.full((L, W), -1, dtype=np.int32)
    for i, x in enumerate(rows):
        a[i, : len(x)] = x
    n_hit = sum(len(x) > 0 for x in rows)
    return empty_before, L - n_hit, a, n_hit


@pytest.mark.parametrize("kind", ["reads", "junk_head", "junk_inside",
                                  "no_hit"])
@pytest.mark.parametrize("graph", ["bench", "k16"])
def test_native_block_matches_the_python_backfill(graphs, graph, kind):
    """seed_mappings_arrays' native blocks equal, array for array, the
    Python backfill and fill over the chain DP's rows, and the counters
    count what the Python filled."""
    dbg, idx, real, clean = graphs[graph]
    reads = _reads_of(kind, real, clean)
    st = tracing.StageTimes(k=dbg.k)
    with tracing.collecting(st):
        arrs = S.seed_mappings_arrays(dbg, reads)
    assert len(arrs) == len(reads)
    filled = unseeded = n_hit = 0
    for rb, a in zip(reads, arrs):
        before, after, ref, hit = _reference(idx, rb)
        assert a.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(a, ref)
        filled += before - after
        unseeded += ref.shape[1] == 1 and hit == 0
        n_hit += hit
        if kind == "junk_head":  # leading rows only the backward sweep fills
            assert before > after == 0 and (ref[0] >= 0).any()
        if kind == "junk_inside":
            assert before > after == 0
        if kind == "no_hit":
            assert ref.shape == (len(rb), 1) and (ref == -1).all()
    assert st.seed_rows_backfilled == filled
    assert st.reads_unseeded == unseeded == (kind == "no_hit")
    assert st.seed_hit_positions == n_hit
    assert st.seed_positions == sum(map(len, reads))
    if kind == "no_hit":
        assert filled == 0
    elif graph == "bench" or kind != "reads":
        assert filled > 0
