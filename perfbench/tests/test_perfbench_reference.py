"""The reference's decode (forward, backward over the stored cells,
posteriors and the mapping rule) gives the program's plain decodes' sets
and posteriors in float64 on a toy graph: the dense decode, the
dense-compute sparse-adaptive decode (top-A stored cells) and the refine
over a hint."""

import numpy as np
import pytest
import torch

from perfbench import checks, inputs, program, run
from perfbench.reference import phmm as P


@pytest.fixture(scope="module")
def toy_case(toy):
    root, bench = toy
    cell = run.Cell("toy.k16_map", bench, root)
    draft = program.module("multi_dbg.output").from_dbg_string(
        inputs.draft_text(cell.cfg, root))
    reads = inputs.reads(cell.cfg, 5, 0, root)[:4]
    fwd = program.module("ops.forward")
    params = program.module("phmm.params").PHMMParams.uniform(0.001)
    dm = fwd.to_device(draft.to_phmm(params, mode="non_zero"), "cpu",
                       torch.float64)
    codes, lens = fwd.pad_reads(reads)
    g = program.graph_of(draft)
    m = P.model(g, [(None, P.Params(0.001))])
    rc, rl = P.encode(reads)
    return dm, torch.as_tensor(codes), torch.as_tensor(lens), g, m, rc, rl


def _same(prog_nodes, prog_logs, tab, m, rc, rl):
    post = P.posterior(m, rc, rl, tab)
    lens = [int(x) for x in rl]
    gap = checks.set_gap(
        [np.asarray(prog_nodes[b, :n]) for b, n in enumerate(lens)],
        [np.asarray(prog_logs[b, :n]) for b, n in enumerate(lens)],
        tab.nodes[0], post[0])
    assert gap < 1e-9
    nd, lg = checks.select_lists(tab.nodes[0], post[0], lens)
    for b, n in enumerate(lens):
        want = np.asarray(prog_nodes[b, :n])
        got = np.full(want.shape, -1)
        w = min(want.shape[1], nd[b].shape[1])
        got[:, :w] = nd[b][:, :w]
        assert (np.sort(got, 1) == np.sort(want, 1)).all()


def test_dense_decode(toy_case):
    dm, codes, lens, g, m, rc, rl = toy_case
    fwd = program.module("ops.forward")
    logp, _f, nodes, logs = fwd.node_freqs_and_mappings(
        dm, codes, lens, n_active=checks.MAPPING_WIDTH,
        max_ratio=checks.MAPPING_RATIO)
    tab = P.tables(m, rc, rl)
    assert np.allclose(tab.logp[0].numpy(), logp.numpy(), rtol=1e-12)
    _same(nodes, logs, tab, m, rc, rl)


@pytest.mark.parametrize("n_top", [2, 4])
def test_sparse_adaptive_decode_and_refine(toy_case, n_top):
    dm, codes, lens, g, m, rc, rl = toy_case
    ad = program.module("ops.adaptive")
    A = n_top * (P.degree(g) + 1)
    logp, nodes, logs = ad.mappings_sparse_adaptive(
        dm, codes, lens, n_top=n_top, n_active=checks.MAPPING_WIDTH,
        max_ratio=checks.MAPPING_RATIO, n_warmup=codes.shape[1])
    tab = P.tables(m, rc, rl, keep=A)
    assert np.allclose(tab.logp[0].numpy(), logp.numpy(), rtol=1e-12)
    _same(nodes, logs, tab, m, rc, rl)
    hint = nodes[:, :, :3].clone()
    logp, nodes, logs = ad.mappings_refine(
        dm, codes, lens, hint, n_active=checks.MAPPING_WIDTH,
        max_ratio=checks.MAPPING_RATIO)
    tab = P.tables(m, rc, rl, sets=hint[None].long())
    assert np.allclose(tab.logp[0].numpy(), logp.numpy(), rtol=1e-12)
    _same(nodes, logs, tab, m, rc, rl)
