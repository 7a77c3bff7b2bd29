"""The port's benchmark (dbgphmm_tpu_torch.bench, ``speed-test``) at toy
shapes on the CPU, where every part runs its kernel's float64 twin: the
lines it prints, and the synthetic case's scores against the JAX
package's log-space Pallas kernel in interpret mode.  That ``speed-test``
without ``--device cpu`` refuses a machine with no GPU is a case of
tests/test_torch_cli.py::test_cli_refuses_cuda_without_a_gpu."""

import json

import jax.numpy as jnp
import numpy as np

from dbgphmm_tpu.ops.forward import to_device as jax_to_device
from dbgphmm_tpu.ops.pallas_mapped import (build_streams, eff_tables,
                                           lin_params_vector,
                                           pallas_mapped_scores)
from dbgphmm_tpu.ops.sparse import precompute_positions as jax_positions
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.phmm.template import PHMMTemplate as JaxTemplate
from dbgphmm_tpu_torch import bench
from dbgphmm_tpu_torch.ops.mapped_scorer import MappedScorer
from dbgphmm_tpu_torch.ops.sparse import precompute_positions
from dbgphmm_tpu_torch.phmm.params import PHMMParams

from test_torch_posterior import one_torch_thread  # noqa: F401

TOY = dict(n=2000, B=4, L=200, A=8, C=4, fb_B=8, fb_L=100, real_reads=2,
           real_len=300, real_cands=4)
REL_TOL, ABS_TOL = 1e-5, 0.05  # the smoke's per-read kernel tolerance


def test_bench_prints_three_lines_headline_last(capsys):
    lines = bench.main(device="cpu", **TOY)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [ln["metric"] for ln in lines] == [
        "torch_mapped_forward_k1_scorings_per_sec_k10k",
        "torch_fwd_bwd_mapping_reads_per_sec_k10k",
        "torch_real_graph_k1_scorings_per_sec_k40"]
    for ln in lines:
        assert {"metric", "value", "unit", "vs_baseline", "device"} <= set(ln)
        assert ln["device"] == "cpu"
        assert np.isfinite(ln["value"]) and ln["value"] > 0
        assert ln["vs_baseline"] == ln["value"] / bench.BASELINE_READS_PER_SEC
    assert "float64 twin" in lines[0]["unit"] and "B=8" in lines[1]["unit"]
    assert "C=4 distinct candidates x 2 reads of up to 300" in lines[2]["unit"]


def test_synthetic_case_matches_the_jax_kernel():
    """The synthetic case at a toy chain (up-only candidates, so no read
    re-enters through a copy-0 edge): the port's K1 twin through
    MappedScorer against the JAX package's log-space Pallas kernel in
    interpret mode on the same template, positions and candidates."""
    x = bench.synthetic_inputs(n=2000, D=2, B=4, L=200, A=8, C=4, NC=120)
    params = PHMMParams.uniform(0.001)
    tpl = bench.synthetic_template(x, params)
    pos = precompute_positions(x["map_nodes"], tpl.parent_idx,
                               parent_exists=tpl.parent_exists)
    got = MappedScorer(tpl, pos, x["codes"], x["lens"], params,
                       "cpu").per_read(x["cands"])

    jparams = jax_params.PHMMParams.uniform(0.001)
    jtpl = JaxTemplate(**{f: getattr(tpl, f) for f in (
        "emission", "emittable", "src_node", "full_to_compact", "parent_idx",
        "parent_exists", "child_idx", "child_exists", "n_nodes_graph")},
        params=jparams)
    jpos = jax_positions(x["map_nodes"], jtpl.parent_idx,
                         parent_exists=jtpl.parent_exists)
    streams = build_streams(jtpl, jpos, x["codes"], x["lens"], None)
    eff, inv_total = eff_tables(streams, x["cands"])
    ltv = lin_params_vector(jax_to_device(jtpl.model_for(x["cands"][0]),
                                          dtype=jnp.float32))
    ref = np.asarray(pallas_mapped_scores(
        jnp.asarray(eff), jnp.asarray(inv_total), *(jnp.asarray(a) for a in (
            streams.lens, streams.codes, streams.emis, streams.numce,
            streams.selfp, streams.prevp, streams.curp, streams.dence)),
        ltv, n_max_gaps=jparams.n_max_gaps, TL=8, space="log",
        interpret=True))[:len(x["cands"]), :4].astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    err = np.abs(got - ref)
    assert (err <= REL_TOL * np.abs(ref) + ABS_TOL).all(), err.max()
    assert got.sum(1).argmax() == ref.sum(1).argmax()

