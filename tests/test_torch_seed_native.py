"""The native seeder (``seed_read_native`` over ``csrc/host/seedchain.cpp``)
against the pure-Python seeder (``seed_read``) of the port's copy of the
JAX package's seeder, ``dbgphmm_tpu_torch.multi_dbg.seed``.  Every k-stage
of the port's main path starts from it.

The two keep the same candidate set at every position where neither reaches
the union width cap ``UNION_WIDTH``.  At the cap they may keep different
members of a tie, so there only the width is compared.  The order within a
set may differ (the union is a set).
"""

from pathlib import Path

import numpy as np
import pytest

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
