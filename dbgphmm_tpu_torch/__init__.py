"""dbgphmm_tpu_torch — the PyTorch / CUDA port of dbgphmm_tpu.

A second package beside the JAX one.  It runs the whole inference path
(mapping decodes, hint-constrained refine, exact-match seeding, candidate
scoring, purge and extension) with PyTorch: float64 on the CPU for parity
with the JAX package, float32 on an NVIDIA Hopper GPU, where candidate
scoring is the hand-written CUDA kernels ``csrc/mapped_scorer.cu`` and
``csrc/mapped_scorer_linear.cu``; on one device, or sharded over a
("cand", "reads") mesh of devices and ``torch.distributed`` ranks.

The host layers (sequences, k-mers, graphs, flow, seeding, neighbours,
Euler counts, the PHMM model and template, read simulation, file formats)
are the port's own copies of the JAX package's modules, under the same
relative paths (``prob``, ``hist``, ``kmer``, ``hashdbg``, ``e2e``,
``utils``, ``seq``, ``graph``, ``flow``, ``phmm``, ``multi_dbg``), and
their native helpers are built from ``csrc/host/``.  This package imports
``torch`` and never ``jax``, nor anything of ``dbgphmm_tpu``.

Layers:
  ops.forward        -- DeviceModel, padding, dtype policy; the dense
                        forward/backward and posterior decode
  ops.freqs          -- transition and init usage expectations (Q score)
  ops.sparse         -- slot positions (csrc/host/positions.cpp), the
                        mapping-constrained forward
  ops.adaptive       -- sparse-adaptive decode, hint-constrained refine
  ops.batch          -- candidate-stacked likelihoods (batch scoring)
  ops.mapped_scorer  -- streams, the K1/K2/K3 kernel wrappers, their twins,
                        MappedScorer
  multi_dbg.posterior-- mappings, scoring, hill climb, k-extension loop
  multi_dbg.output   -- DBG / MAP / POST / GFA / INSPECT files on the port's types
  parallel           -- the ("cand", "reads") mesh, sharded puts and gathers,
                        torch.distributed ranks over gloo (multihost)
  cli                -- the JAX CLI's commands and --mesh / --dist, plus --device
  dryrun             -- entry() and dryrun_multichip(), as __graft_entry__
"""

__version__ = "0.1.0"
