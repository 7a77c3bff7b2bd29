"""The port's hint-constrained refine (dbgphmm_tpu_torch.ops.adaptive) and
seeded generate_mappings against the JAX package, in float64 on the CPU,
on the fixture of tests/test_seed.py (k=16 tandem repeat, 12 reads x 200
bp, seeds from seed_mappings_arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu.e2e import ReadType, generate_dataset
from dbgphmm_tpu.multi_dbg import MultiDbg
from dbgphmm_tpu.multi_dbg import posterior as JP
from dbgphmm_tpu.multi_dbg.seed import seed_mappings_arrays
from dbgphmm_tpu.ops import pad_reads, to_device
from dbgphmm_tpu.ops.adaptive import mappings_refine as jax_refine
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.seq import genome as G
from dbgphmm_tpu_torch import e2e as port_e2e
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch.multi_dbg import posterior as TP
from dbgphmm_tpu_torch.ops.adaptive import mappings_refine
from dbgphmm_tpu_torch.ops.forward import device_model_from_numpy
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.seq import genome as port_genome


@pytest.fixture(scope="module")
def setup():
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0
    )
    ds = generate_dataset(g, 0, 6, 200, ReadType.FIXED_SIZE_FRAGMENT,
                          PHMMParams.uniform(0.005))
    dbg = MultiDbg.from_styled_seqs(16, list(g))
    reads = list(ds.reads)[:12]
    params = PHMMParams.uniform(0.005)
    seeds = seed_mappings_arrays(dbg, reads)
    # the port's graph, parameters and reads, from the same inputs
    g_t = port_genome.tandem_repeat_polyploid_with_unique_homo_ends(
        50, 4, 0, 0.02, 0, 100, 2, 0.01, 0
    )
    params_t = port_params.PHMMParams.uniform(0.005)
    ds_t = port_e2e.generate_dataset(g_t, 0, 6, 200,
                                     port_e2e.ReadType.FIXED_SIZE_FRAGMENT,
                                     params_t)
    reads_t = list(ds_t.reads)[:12]
    assert [bytes(r) for r in reads_t] == [bytes(r) for r in reads]
    dbg_t = port_multi_dbg.MultiDbg.from_styled_seqs(16, list(g_t))
    return dbg, reads, params, seeds, (dbg_t, reads_t, params_t)


def _jax_fields(dm):
    fields = {f: np.asarray(getattr(dm, f)) for f in
              ("emission", "init_logp", "parent_idx", "parent_logt",
               "child_idx", "child_logt")}
    fields["lt"] = np.asarray(dm.lt)
    fields["n_max_gaps"] = dm.n_max_gaps
    return fields


def test_mappings_refine_matches_jax(setup):
    """Same model (carried over with device_model_from_numpy), same codes
    and seeded hint: logp to rtol 1e-9, map_nodes equal, finite map_logp
    to atol 1e-8."""
    dbg, reads, params, seeds, _port = setup
    dm = to_device(dbg.to_phmm(params, mode="non_zero"), dtype=jnp.float64)
    codes, lens = pad_reads(reads)
    hint = JP._pad_hint_nodes(
        JP.Mappings(seeds, [np.zeros(a.shape) for a in seeds]),
        codes.shape[1], 2 * JP.MAPPING_WIDTH_CAP)
    lp_j, mn_j, ml_j = (np.asarray(a) for a in jax_refine(
        dm, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(hint),
        n_active=JP.MAPPING_WIDTH_CAP, max_ratio=params.active_node_max_ratio))

    tdm = device_model_from_numpy(_jax_fields(dm), "cpu")
    assert tdm.dtype == torch.float64
    lp_t, mn_t, ml_t = (a.numpy() for a in mappings_refine(
        tdm, torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(hint), n_active=JP.MAPPING_WIDTH_CAP,
        max_ratio=params.active_node_max_ratio))

    assert np.isfinite(lp_j).all()
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(mn_t, mn_j)
    fin = np.isfinite(ml_j)
    np.testing.assert_array_equal(np.isfinite(ml_t), fin)
    np.testing.assert_allclose(ml_t[fin], ml_j[fin], rtol=0, atol=1e-8)


def test_generate_mappings_with_seed_hint_matches_jax(setup):
    """generate_mappings(hint=seeds, hint_regen=False) in both packages:
    read_logps to rtol 1e-9, identical trimmed node sets, finite logps to
    atol 1e-8."""
    dbg, reads, params, seeds, (dbg_t, reads_t, params_t) = setup
    hint = lambda M: M.Mappings(seeds, [np.zeros(a.shape) for a in seeds],
                                None, None, -1)
    ref = JP.generate_mappings(dbg, params, reads, hint=hint(JP),
                               hint_regen=False)
    got = TP.generate_mappings(dbg_t, params_t, reads_t, "cpu", hint=hint(TP),
                               hint_regen=False)
    np.testing.assert_allclose(got.read_logps, ref.read_logps, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.anchor_logps, ref.anchor_logps, rtol=1e-9,
                               atol=0)
    assert got.stages_since_anchor == ref.stages_since_anchor
    assert got.gate_rate == ref.gate_rate
    for a, b, la, lb in zip(got.nodes, ref.nodes, got.logps, ref.logps):
        np.testing.assert_array_equal(a, b)
        fin = np.isfinite(lb)
        np.testing.assert_array_equal(np.isfinite(la), fin)
        np.testing.assert_allclose(la[fin], lb[fin], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.to_node_freqs(dbg.n_edges_full()),
                               ref.to_node_freqs(dbg.n_edges_full()),
                               rtol=1e-9, atol=1e-12)
