"""The benchmark of ``dbgphmm_tpu_torch``, the PyTorch and CUDA port: one
command (``python3 -m perfbench.run``) runs one cell of ``BENCHMARK.json``
on one card.  Everything that belongs to one configuration, traffic mix,
metric or kernel is a file of its own here, found by name."""
