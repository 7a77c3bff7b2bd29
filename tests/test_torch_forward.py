"""The port's model and read padding (dbgphmm_tpu_torch.ops.forward) against
the JAX package's, and the port's freedom from JAX."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu import multi_dbg as jax_multi_dbg
from dbgphmm_tpu.ops import forward as JF
from dbgphmm_tpu.phmm import model as jax_model
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu.seq import genome as jax_genome
from dbgphmm_tpu_torch import multi_dbg as port_multi_dbg
from dbgphmm_tpu_torch.ops import forward as TF
from dbgphmm_tpu_torch.phmm import model as port_model
from dbgphmm_tpu_torch.phmm import params as port_params
from dbgphmm_tpu_torch.seq import genome as port_genome

REPO = Path(__file__).resolve().parent.parent
ARRAYS = ("emission", "init_logp", "parent_idx", "parent_logt", "child_idx",
          "child_logt")


def _models(multi_dbg, model, params, genome):
    """The test models, built by one package's host layers."""
    p = params.PHMMParams.uniform(0.01)
    g = genome.tandem_repeat_polyploid_with_unique_homo_ends(
        10, 4, 0, 0.0, 0, 20, 2, 0.05, 0)
    dbg = multi_dbg.MultiDbg.from_styled_seqs(8, list(g))
    return {
        "linear": model.linear_phmm(b"ATTCGATCGTTAGGCAT", p),
        "dbg_non_zero": dbg.to_phmm(p, mode="non_zero"),
        "dbg_normal": dbg.to_phmm(p),
    }


# the port's models (from its own host layers) and the JAX package's
MODELS = _models(port_multi_dbg, port_model, port_params, port_genome)
JAX_MODELS = _models(jax_multi_dbg, jax_model, jax_params, jax_genome)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pad_model_matches_jax(name):
    ours, ref = TF.pad_model(MODELS[name]), JF.pad_model(JAX_MODELS[name])
    for f in ARRAYS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_to_device_matches_jax(name):
    """float64 on the CPU: every array and log transition equals the JAX
    package's DeviceModel exactly."""
    ours = TF.to_device(MODELS[name], "cpu")
    ref = JF.to_device(JAX_MODELS[name], dtype=jnp.float64)
    assert ours.dtype == torch.float64 and ours.n_max_gaps == ref.n_max_gaps
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(torch.stack(list(ours.lt)).numpy(),
                                  np.asarray(ref.lt))
    assert TF.default_dtype("cpu") == torch.float64
    assert TF.default_dtype("cuda") == torch.float32


def test_device_model_from_numpy_round_trips():
    ref = JF.to_device(JAX_MODELS["dbg_non_zero"], dtype=jnp.float64)
    fields = {f: np.asarray(getattr(ref, f)) for f in ARRAYS}
    fields.update(lt=np.asarray(ref.lt), n_max_gaps=ref.n_max_gaps)
    dm = TF.device_model_from_numpy(fields, "cpu")
    direct = TF.to_device(MODELS["dbg_non_zero"], "cpu")
    for f in ARRAYS:
        assert getattr(dm, f).dtype == getattr(direct, f).dtype
        assert torch.equal(getattr(dm, f), getattr(direct, f)), f
    assert torch.equal(torch.stack(list(dm.lt)), torch.stack(list(direct.lt)))
    # and back: the port's arrays rebuild the same model
    again = TF.device_model_from_numpy(
        {**{f: getattr(dm, f).numpy() for f in ARRAYS},
         "lt": dict(zip(TF.LogTrans._fields, [v.item() for v in dm.lt])),
         "n_max_gaps": dm.n_max_gaps}, "cpu")
    for f in ARRAYS:
        assert torch.equal(getattr(again, f), getattr(dm, f)), f


@pytest.mark.parametrize("pad_to", [None, 40])
def test_pad_reads_matches_jax(pad_to):
    rng = np.random.default_rng(7)
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
             for n in (5, 17, 31, 1)]
    for a, b in zip(TF.pad_reads(reads, pad_to=pad_to),
                    JF.pad_reads(reads, pad_to=pad_to)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 128, 129, 1000, 43743])
def test_bucketize_matches_jax(n):
    assert TF.bucketize(n) == JF.bucketize(n)


def test_ratio_mask_matches_jax():
    rng = np.random.default_rng(3)
    lp = np.sort(rng.normal(-20, 15, (6, 9)), axis=1)[:, ::-1].copy()
    lp[:, 6:] = -np.inf
    idx = rng.integers(0, 100, (6, 9)).astype(np.int32)
    ref = JF._ratio_mask(jnp.asarray(lp), jnp.asarray(idx), 30.0)
    got = TF._ratio_mask(torch.as_tensor(lp), torch.as_tensor(idx), 30.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "dbgphmm_tpu_torch").rglob("*.py")
        if p.name != "__main__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print(len(" + repr(mods) + "))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods) >= 10
