"""The port's dry run (dbgphmm_tpu_torch.dryrun) against the JAX package's
``__graft_entry__``: ``entry()``'s forward scores, and
``dryrun_multichip(8)`` on 8 copies of the CPU in float64 against the JAX
``sample_posterior`` over conftest's 8 virtual devices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dbgphmm_tpu.multi_dbg import MultiDbg as JaxMultiDbg
from dbgphmm_tpu.multi_dbg.posterior import generate_mappings, sample_posterior
from dbgphmm_tpu.ops import to_device as jax_to_device
from dbgphmm_tpu.parallel import make_mesh
from dbgphmm_tpu.phmm.params import PHMMParams
from dbgphmm_tpu.seq.collection import ReadCollection, StyledSequence
from dbgphmm_tpu.seq.random_seq import generate
from dbgphmm_tpu_torch import dryrun

from test_torch_posterior import one_torch_thread  # noqa: F401


def test_entry_matches_jax():
    """The forward step on the flagship toy: the port's arguments on the
    CPU (float64) through its fn equal the JAX fn on the same toy in
    float64 within 1e-9, and the JAX entry's own float32 output within
    float32 rounding."""
    fn, (dm, codes, lens) = dryrun.entry("cpu")
    assert dm.dtype == torch.float64 and codes.shape == (8, 60)
    got = fn(dm, codes, lens).numpy()
    assert np.isfinite(got).all()

    fn_j, (dm32, codes_j, lens_j) = graft.entry()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    dbg = JaxMultiDbg.from_styled_seqs(12, [StyledSequence.linear(generate(120, 0))])
    dm64 = jax_to_device(dbg.to_phmm(PHMMParams.uniform(0.001)),
                         dtype=jnp.float64)
    np.testing.assert_allclose(got, np.asarray(fn_j(dm64, codes_j, lens_j)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(fn_j(dm32, codes_j, lens_j)),
                               rtol=1e-5, atol=0)


def test_dryrun_multichip_matches_jax(capsys):
    """dryrun_multichip(8) on the CPU (a 2x4 mesh, float64) recovers
    [2, 1, 1, 2] and prints the JAX dry run's line; its samples and
    likelihoods equal the JAX sample_posterior over a 2x4 mesh within
    1e-6."""
    post = dryrun.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out
    assert "dryrun_multichip OK: n_devices=8 mesh={'cand': 2, 'reads': 4}" in line
    assert post.max_copy_nums() == [2, 1, 1, 2]

    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGATTCAAGGC"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGATTCAAGGC"
    dbg = JaxMultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    reads = ReadCollection(
        [h1[1:30], h2[3:33], h1[:25], h2[10:38], h1[5:35], h2[:20]])
    params = PHMMParams.uniform(0.001)
    G = dbg.genome_size()
    dbg.set_copy_nums([2, 2, 0, 2])
    mesh = make_mesh(8, cand_axis=2)
    ref = sample_posterior(dbg, params, reads,
                           generate_mappings(dbg, params, reads), G, 100,
                           max_iter=3, mesh=mesh)
    assert post.max_copy_nums() == ref.max_copy_nums()
    assert {tuple(s.copy_nums) for s in post.samples} == {
        tuple(s.copy_nums) for s in ref.samples}
    for s in post.samples:
        r = ref.find(s.copy_nums).score
        assert s.score.likelihood == pytest.approx(r.likelihood, abs=1e-6)


def test_dryrun_multichip_on_repeated_devices(capsys):
    """The smoke's form: an explicit device list that repeats one device
    (a 2x2 mesh of one CPU), and a mesh of more CUDA devices than are
    visible refused."""
    post = dryrun.dryrun_multichip(4, devices=[torch.device("cpu")] * 4)
    assert "mesh={'cand': 2, 'reads': 2}" in capsys.readouterr().out
    assert post.max_copy_nums() == [2, 1, 1, 2]
    with pytest.raises(ValueError, match="CUDA devices"):
        dryrun.dryrun_multichip(torch.cuda.device_count() + 2)
