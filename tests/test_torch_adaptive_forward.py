"""The port's sparse-adaptive forward (dbgphmm_tpu_torch.ops.adaptive.
forward_sparse_adaptive, the wrapper of the kernels A1 and A2) against the
JAX package's forward_sparse_adaptive, in float64 on the CPU, where the
wrapper runs its plain version (forward_sparse_adaptive_reference).  The
wrapper's input checks are exercised on tensors on the ``meta`` device,
which refuse before any launch; tests/test_torch_cuda.py holds the kernels
to the plain version on a card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgphmm_tpu import ops as J
from dbgphmm_tpu.ops import adaptive as JA
from dbgphmm_tpu.phmm import model as jax_model
from dbgphmm_tpu.phmm import params as jax_params
from dbgphmm_tpu_torch.ops import adaptive as AD
from dbgphmm_tpu_torch.ops import forward as T
from dbgphmm_tpu_torch.phmm import PHMMParams
from dbgphmm_tpu_torch.phmm import model as port_model
from dbgphmm_tpu_torch.seq.random_seq import generate

from test_torch_cuda import random_refine_case
from test_torch_posterior import one_torch_thread  # noqa: F401

# (graph size, read slices, forward_sparse_adaptive's arguments); n_warmup
# None = the read length (the dense-compute regime: A1 alone on a card)
CASES = {
    "dense_a_below_n": (300, [(20, 140), (100, 220)], dict(n_top=20, n_warmup=None)),
    "dense_a_is_n": (100, [(60, 95), (5, 60)], dict(n_top=60, n_warmup=None)),
    "frontier_max_ratio": (300, [(20, 140), (100, 220)],
                           dict(n_top=12, n_warmup=8, max_ratio=8.0)),
    "frontier_stored_bf16": (300, [(20, 140), (100, 220)],
                             dict(n_top=20, n_warmup=8, max_ratio=30.0,
                                  stored_k=24, store_bf16=True)),
    "short_reads": (300, [(20, 140), (150, 170), (7, 7), (30, 33)],
                    dict(n_top=20, n_warmup=10)),
}


def _models(n, seed):
    """(port model on the CPU, JAX model) of linear_random_phmm(n, seed),
    float64."""
    pm = port_model.linear_random_phmm(n, seed, PHMMParams.default())
    jm = jax_model.linear_random_phmm(n, seed, jax_params.PHMMParams.default())
    return T.to_device(pm, "cpu", torch.float64), J.to_device(jm, dtype=jnp.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    """The wrapper on a CPU model equals the JAX forward_sparse_adaptive:
    the stored nodes and the -inf patterns equal, m / i / d (bfloat16 rows
    as stored), off and e to 1e-9 relative."""
    n, slices, kw = CASES[case]
    dm, jdm = _models(n, 3)
    seq = generate(n, 3)
    codes, lens = T.pad_reads([seq[a:b] for a, b in slices])
    kw = dict(kw)
    if kw["n_warmup"] is None:
        kw["n_warmup"] = int(codes.shape[1])
    got = AD.forward_sparse_adaptive(dm, torch.as_tensor(codes),
                                     torch.as_tensor(lens), **kw)
    ref = JA.forward_sparse_adaptive(jdm, jnp.asarray(codes), jnp.asarray(lens),
                                     **kw)
    K = got.nodes.shape[2]
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(ref.nodes))
    for name in ("m", "i", "d", "off", "e"):
        a = getattr(got, name).double().numpy()
        b = np.asarray(getattr(ref, name)).astype(np.float64)
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b), name)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0, err_msg=name)
    if kw.get("store_bf16"):
        assert got.m.dtype == torch.bfloat16 and K == kw["stored_k"]
    assert np.isfinite(got.e.numpy()[lens > 0]).all()


def test_cpu_forward_runs_the_plain_version():
    """On a CPU model the wrapper runs the plain version once per call and
    launches neither kernel."""
    dm, codes, lens, _hint = random_refine_case(60, 3, 3, 12, 8, torch.float64,
                                                 seed=3)
    calls = AD.forward_sparse_adaptive_reference.calls
    launches = (AD.adaptive_dense.launches, AD.adaptive_frontier.launches,
                AD.forward_sparse_adaptive.launches)
    f = AD.forward_sparse_adaptive(dm, codes, lens, n_top=4, n_warmup=5)
    assert AD.forward_sparse_adaptive_reference.calls == calls + 1
    AD.mappings_sparse_adaptive(dm, codes, lens, n_top=4, n_active=5)
    assert AD.forward_sparse_adaptive_reference.calls == calls + 2
    assert (AD.adaptive_dense.launches, AD.adaptive_frontier.launches,
            AD.forward_sparse_adaptive.launches) == launches == (0, 0, 0)
    assert f.nodes.shape == (12, 3, 16) and f.e.shape == (3,)


def _meta(dm, codes, lens):
    """The same inputs on the meta device: shapes and dtypes, no data."""
    fields = {f.name: getattr(dm, f.name) for f in dataclasses.fields(dm)}
    to = lambda t: t.to("meta")
    fields.update({k: to(v) for k, v in fields.items()
                   if isinstance(v, torch.Tensor)})
    fields["lt"] = type(dm.lt)(*[to(v) for v in dm.lt])
    return type(dm)(**fields), to(codes), to(lens)


@pytest.mark.parametrize("bad", ["cells", "int64", "strided", "float16",
                                 "degree", "gaps", "n_top", "meta"])
def test_forward_wrapper_refuses_before_launch(bad):
    """The wrapper's input check, on tensors that are not on the CPU (here
    the meta device): more than 512 carried cells, int64 or non-contiguous
    codes, a float16 model, a degree above 5, more than 32 deletion rounds,
    n_top < 1 are refused with a ValueError naming the fault, and a
    well-formed input off the card with one naming the device; nothing is
    built or launched."""
    dm, codes, lens = _meta(*random_refine_case(900, 3, 2, 10, 8,
                                                torch.float32, seed=2)[:3])
    launches = (AD.adaptive_dense.launches, AD.adaptive_frontier.launches)
    kw = dict(n_top=40)
    match = {"cells": "width 520", "int64": "int64", "strided": "contiguous",
             "float16": "float16", "degree": "degree", "gaps": "n_max_gaps",
             "n_top": "n_top=0", "meta": "not meta"}
    if bad == "cells":
        kw["n_top"] = 130
    if bad == "int64":
        codes = codes.long()
    if bad == "strided":
        codes = torch.empty((10, 2), dtype=torch.int32, device="meta").t()
    if bad == "float16":
        dm = dataclasses.replace(dm, init_logp=dm.init_logp.half())
    if bad == "degree":
        dm, codes, lens = _meta(*random_refine_case(900, 6, 2, 10, 8,
                                                    torch.float32, seed=2)[:3])
    if bad == "gaps":
        dm = dataclasses.replace(dm, n_max_gaps=33)
    if bad == "n_top":
        kw["n_top"] = 0
    with pytest.raises(ValueError, match=match[bad]):
        AD.forward_sparse_adaptive(dm, codes, lens, **kw)
    assert (AD.adaptive_dense.launches, AD.adaptive_frontier.launches) == launches
