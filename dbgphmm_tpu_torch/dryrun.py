"""Entry points for a quick check of the port, the counterpart of the JAX
package's ``__graft_entry__.py``.

* ``entry()`` — the dense forward scoring step (``ops.forward.
  forward_scores``) on the flagship toy, with its example arguments.
* ``dryrun_multichip(n_devices)`` — one real inference step
  (``sample_posterior`` with mappings: rescue neighbours, mapped candidate
  scoring, multi-move acceptance) over an n-device ("cand", "reads") mesh,
  held sample for sample against the single-device run.

    python -m dbgphmm_tpu_torch.dryrun                # every visible GPU
    python -m dbgphmm_tpu_torch.dryrun 8 --device cpu # 8 copies of the CPU
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def _check(ok, what: str) -> None:
    """The dry run's assertion, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def _flagship(device, k: int = 12, genome_len: int = 120, n_reads: int = 8,
              read_len: int = 60):
    from .multi_dbg import MultiDbg
    from .ops.forward import pad_reads, to_device
    from .phmm.params import PHMMParams
    from .seq.collection import StyledSequence
    from .seq.random_seq import generate

    seq = generate(genome_len, 0)
    dbg = MultiDbg.from_styled_seqs(k, [StyledSequence.linear(seq)])
    dm = to_device(dbg.to_phmm(PHMMParams.uniform(0.001)), device)
    rng = np.random.default_rng(0)
    reads = []
    for _ in range(n_reads):
        st = int(rng.integers(0, genome_len - read_len + 1))
        reads.append(seq[st:st + read_len])
    codes, lens = pad_reads(reads)
    return dm, codes, lens


def entry(device="cuda"):
    """(fn, example_args): the forward scoring step on the flagship toy (a
    k=12 DBG of a random 120-base sequence, 8 reads of 60 bases), its
    arguments on ``device`` (float64 on the CPU, float32 on CUDA)."""
    from .ops.forward import forward_scores

    device = torch.device(device)
    dm, codes, lens = _flagship(device)

    def fn(dm, codes, lens):
        return forward_scores(dm, codes, lens, renorm=True)

    return fn, (dm, torch.as_tensor(codes, device=device),
                torch.as_tensor(lens, device=device))


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     device="cuda"):
    """Run ONE production inference step over an n-device mesh (cand 2
    when ``n_devices`` is even): the diploid 8-mer toy, started from the
    perturbed copy numbers [2, 2, 0, 2].  Asserts that the sharded
    mappings equal the local ones, that the sharded posterior equals the
    local one sample for sample, and that the climb recovers [2, 1, 1, 2].
    ``devices`` names the mesh's devices (they may repeat); otherwise the
    mesh is the first ``n_devices`` of ``device`` (more CUDA devices than
    are visible is an error).  Returns the sharded Posterior."""
    from .multi_dbg import MultiDbg
    from .multi_dbg.posterior import generate_mappings, sample_posterior
    from .parallel.sharding import make_mesh
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection, StyledSequence

    # 2D mesh: candidate-parallel x read-parallel when possible
    cand_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, cand_axis=cand_axis, device=device,
                     devices=devices)
    dev = mesh.devices.flat[0]

    # small diploid DBG: branching graph, distinct rescue candidates
    h1 = b"TTAGGCTTCGATCGAATGCCAGGTTACGGATTCAAGGC"
    h2 = b"TTAGGCTTGGATCGAATGCCAGGTTACGGATTCAAGGC"
    dbg = MultiDbg.from_styled_seqs(
        8, [StyledSequence.linear(h1), StyledSequence.linear(h2)])
    reads = ReadCollection(
        [h1[1:30], h2[3:33], h1[:25], h2[10:38], h1[5:35], h2[:20]])
    params = PHMMParams.uniform(0.001)
    G = dbg.genome_size()

    # start from a wrong (but flow-valid) assignment so the rescue pass
    # produces distinct improving candidates and the climb has real work
    _check(dbg.get_copy_nums() == [2, 1, 1, 2], "the toy's copy numbers")
    dbg.set_copy_nums([2, 2, 0, 2])

    mappings_l = generate_mappings(dbg, params, reads, dev)
    mappings_s = generate_mappings(dbg, params, reads, dev, mesh=mesh)
    for a, b in zip(mappings_l.nodes, mappings_s.nodes):
        w = min(a.shape[1], b.shape[1])
        _check((a[:, :w] == b[:, :w]).all(), "sharded mapping diverged")

    post_local = sample_posterior(dbg, params, reads, mappings_l, G, 100, dev,
                                  max_iter=3)
    post_shard = sample_posterior(dbg, params, reads, mappings_l, G, 100, dev,
                                  max_iter=3, mesh=mesh)

    _check(len(post_shard.samples) == len(post_local.samples) > 1,
           "expected multiple distinct candidates scored")
    _check(post_shard.max_copy_nums() == post_local.max_copy_nums(),
           "sharded argmax diverged")
    loc = {tuple(s.copy_nums): s.score for s in post_local.samples}
    shd = {tuple(s.copy_nums): s.score for s in post_shard.samples}
    _check(set(loc) == set(shd), "sharded samples diverged")
    # float64 on the CPU; float32 on a GPU, where a kernel's launch shape
    # may change the rounding
    tol = 1e-9 if dev.type == "cpu" else 1e-3
    lls = []
    for key, sc in loc.items():
        d = abs(shd[key].likelihood - sc.likelihood)
        _check(d < tol, f"sharded likelihood diverged by {d}")
        lls.append(shd[key].likelihood)
    _check(len(set(np.round(lls, 6))) > 1, "candidates were not distinct")
    # the climb must recover the true assignment from the perturbed start
    _check(post_shard.max_copy_nums() == [2, 1, 1, 2], "did not recover truth")
    print(
        f"dryrun_multichip OK: n_devices={n_devices} mesh={dict(mesh.shape)} "
        f"samples={len(post_shard.samples)} "
        f"best_p={post_shard.max_sample().score.p():.3f} "
        f"lls={[round(v, 3) for v in sorted(lls)]}"
    )
    return post_shard


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dbgphmm_tpu_torch.dryrun")
    p.add_argument("n_devices", type=int, nargs="?", default=None,
                   help="mesh size (default: every visible GPU; 8 on the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: torch.cuda.is_available() is False; pass "
                         "--device cpu")
    n = args.n_devices or (torch.cuda.device_count() if device.type == "cuda" else 8)
    fn, ex = entry(device)
    print("entry OK:", fn(*ex).cpu().numpy())
    dryrun_multichip(n, device=device)


if __name__ == "__main__":
    main()
