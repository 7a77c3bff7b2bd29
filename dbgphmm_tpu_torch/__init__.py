"""dbgphmm_tpu_torch — the PyTorch / CUDA port of dbgphmm_tpu.

A second package beside the JAX one.  It runs the seeded k-stage inference
path (seeding, hint-constrained refine, candidate scoring, purge and
extension) with PyTorch on one device: float64 on the CPU for parity with
the JAX package, float32 on an NVIDIA Hopper GPU, where candidate scoring is
the hand-written CUDA kernel ``csrc/mapped_scorer.cu``.

The host layers (sequences, k-mers, graphs, flow, seeding, neighbours,
Euler counts, the PHMM model and template, read simulation, file formats)
are the port's own copies of the JAX package's modules, under the same
relative paths (``prob``, ``hist``, ``kmer``, ``hashdbg``, ``e2e``,
``seq``, ``graph``, ``flow``, ``phmm``, ``multi_dbg``), and their native
helpers are built from ``csrc/host/``.  This package imports ``torch``
and never ``jax``, nor anything of ``dbgphmm_tpu``.

Layers:
  ops.forward        -- DeviceModel, padding, dtype policy
  ops.sparse         -- slot positions (csrc/host/positions.cpp), active-set gathers
  ops.adaptive       -- hint-constrained mapping refine
  ops.mapped_scorer  -- streams, the K1 kernel wrapper, its twin, MappedScorer
  multi_dbg.posterior-- mappings, scoring, hill climb, k-extension loop
  multi_dbg.output   -- DBG / MAP / POST / GFA / INSPECT files on the port's types
  cli                -- infer / sim-infer / euler / inspect / sample / sample-from-true
"""

__version__ = "0.1.0"
