"""One reader per metric, found by the metric's name in BENCHMARK.json
(``<name>.py``).  ``read(ctx)`` takes a :class:`perfbench.run.Context`
and returns the value, or None where the run holds nothing to read (the
metric is then left out of the result line)."""
