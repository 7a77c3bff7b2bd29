"""The port's hint-constrained refine (dbgphmm_tpu_torch.ops.adaptive) and
seeded generate_mappings against the JAX package, in float64 on the CPU,
on the fixture of tests/test_seed.py (k=16 tandem repeat, 12 reads x 200
bp, seeds from seed_mappings_arrays).  On the CPU the refine runs the
plain versions of its kernels R1 and R2 (forward_mapped_tables_reference,
decode_from_forward_reference); the wrappers' input checks are exercised
here on tensors on the ``meta`` device, which refuse before any launch."""

import dataclasses

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
from dbgphmm_tpu_torch.ops import adaptive as AD
from dbgphmm_tpu_torch.ops.adaptive import mappings_refine
from dbgphmm_tpu_torch.ops.forward import device_model_from_numpy
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.seq import genome as port_genome

from test_torch_cuda import random_refine_case
from test_torch_posterior import one_torch_thread  # noqa: F401


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


def _edge_case(setup, case):
    """(codes, lens, hint, max_ratio) of one edge the kernels must handle,
    from the fixture's reads and seeded hint."""
    dbg, reads, params, seeds, _port = setup
    ratio = params.active_node_max_ratio
    rng = np.random.default_rng(5)
    if case == "unequal_lengths":  # padding positions at the reads' ends
        reads = [r[:200 - 13 * i] for i, r in enumerate(reads)]
    if case == "cap_width":  # 256 slots: 3 reads of 80 bases keep it quick
        reads, seeds = [r[:80] for r in reads[:3]], seeds[:3]
    codes, lens = pad_reads(reads)
    L = codes.shape[1]
    hint = JP._pad_hint_nodes(
        JP.Mappings([a[:L] for a in seeds], [np.zeros(a[:L].shape) for a in seeds]),
        L, 2 * JP.MAPPING_WIDTH_CAP)
    if case == "holes":  # -1 slots mid-row
        hint = np.where(rng.random(hint.shape) < 0.3, -1, hint).astype(np.int32)
    if case == "cap_width":  # as wide as the 2 * MAPPING_WIDTH_CAP cap
        n = dbg.n_edges_full()
        extra = rng.integers(0, n, hint.shape[:2] + (2 * JP.MAPPING_WIDTH_CAP
                                                     - hint.shape[2],))
        hint = np.concatenate([hint, extra.astype(np.int32)], axis=2)
        assert hint.shape[2] == 2 * JP.MAPPING_WIDTH_CAP
    if case == "no_ratio":
        ratio = None
    return codes, lens, hint, ratio


@pytest.mark.parametrize("case", ["unequal_lengths", "holes", "cap_width",
                                  "no_ratio"])
def test_mappings_refine_edges_match_jax(setup, case):
    """mappings_refine at the edges R1 and R2 must handle, against the JAX
    package on the same model and inputs, in float64: logp to rtol 1e-9,
    map_nodes equal, finite map_logp to rtol 1e-9 (atol 1e-12: a log
    posterior near 0) with the same -inf pattern."""
    dbg, reads, params, seeds, _port = setup
    codes, lens, hint, ratio = _edge_case(setup, case)
    dm = to_device(dbg.to_phmm(params, mode="non_zero"), dtype=jnp.float64)
    lp_j, mn_j, ml_j = (np.asarray(a) for a in jax_refine(
        dm, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(hint),
        n_active=JP.MAPPING_WIDTH_CAP, max_ratio=ratio))
    tdm = device_model_from_numpy(_jax_fields(dm), "cpu")
    lp_t, mn_t, ml_t = (a.numpy() for a in mappings_refine(
        tdm, torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(hint), n_active=JP.MAPPING_WIDTH_CAP, max_ratio=ratio))
    np.testing.assert_array_equal(np.isfinite(lp_t), np.isfinite(lp_j))
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(mn_t, mn_j)
    fin = np.isfinite(ml_j)
    np.testing.assert_array_equal(np.isfinite(ml_t), fin)
    np.testing.assert_allclose(ml_t[fin], ml_j[fin], rtol=1e-9, atol=1e-12)


def test_cpu_refine_runs_the_plain_versions():
    """On the CPU mappings_refine runs R1's and R2's plain versions and
    mappings_sparse_adaptive R2's; no kernel launches."""
    dm, codes, lens, hint = random_refine_case(60, 3, 3, 12, 8, torch.float64,
                                                seed=3)
    counters = (AD.forward_mapped_tables_reference, AD.decode_from_forward_reference)
    before = [f.calls for f in counters]
    launches = (AD.forward_mapped_tables.launches, AD.decode_from_forward.launches)
    lp, mn, ml = AD.mappings_refine(dm, codes, lens, hint, n_active=5,
                                    max_ratio=10.0)
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 1]
    AD.mappings_sparse_adaptive(dm, codes, lens, n_top=4, n_active=5)
    assert [f.calls - b for f, b in zip(counters, before)] == [1, 2]
    assert (AD.forward_mapped_tables.launches,
            AD.decode_from_forward.launches) == launches == (0, 0)
    assert mn.shape == (3, 12, 5) and lp.shape == (3,)


def _meta(dm, codes, lens, hint):
    """The same inputs on the meta device: shapes and dtypes, no data."""
    fields = {f.name: getattr(dm, f.name) for f in dataclasses.fields(dm)}
    to = lambda t: t.to("meta")
    fields.update({k: to(v) for k, v in fields.items()
                   if isinstance(v, torch.Tensor)})
    fields["lt"] = type(dm.lt)(*[to(v) for v in dm.lt])
    return type(dm)(**fields), to(codes), to(lens), to(hint)


@pytest.mark.parametrize("bad", ["wide", "int64", "strided", "float16",
                                 "cells", "meta"])
def test_refine_wrappers_refuse_before_launch(bad):
    """The wrappers' input check, on tensors that are not on the CPU (here
    the meta device): a hint wider than 256 slots, an int64 hint, a
    non-contiguous hint, a float16 model, more than 512 stored cells for R2
    are refused with a ValueError naming the fault, and a well-formed input
    off the card with one naming the device; nothing is built or launched."""
    dm, codes, lens, hint = _meta(*random_refine_case(
        40, 3, 2, 10, 8, torch.float32, seed=2))
    launches = (AD.forward_mapped_tables.launches, AD.decode_from_forward.launches)
    L, B, A = 10, 2, 8
    match = {"wide": "width 257", "int64": "int64", "strided": "contiguous",
             "float16": "float16", "cells": "width 513", "meta": "not meta"}
    with pytest.raises(ValueError, match=match[bad]):
        if bad == "cells":
            tab = lambda dt: torch.empty((L, B, 513), dtype=dt, device="meta")
            f = AD.AdaptiveTables(
                tab(torch.int32), tab(dm.dtype), tab(dm.dtype), tab(dm.dtype),
                torch.empty((L, B), device="meta"),
                torch.empty((B,), device="meta"))
            AD.decode_from_forward(dm, codes, lens, f, 40, None)
        if bad == "wide":
            hint = torch.empty((B, L, 257), dtype=torch.int32, device="meta")
        if bad == "int64":
            hint = hint.long()
        if bad == "strided":
            hint = torch.empty((L, B, A), dtype=torch.int32,
                               device="meta").transpose(0, 1)
        if bad == "float16":
            dm = dataclasses.replace(dm, init_logp=dm.init_logp.half())
        AD.forward_mapped_tables(dm, codes, lens, hint)
    assert (AD.forward_mapped_tables.launches,
            AD.decode_from_forward.launches) == launches
