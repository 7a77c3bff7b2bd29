"""Work counts of the port's kernels, one module per kernel, found by name
(``a1_roofline_pct.stage`` reads ``a1``).  Each module gives

* ``HOOK`` -- (program module, function) whose calls launch the kernel;
* ``KERNEL`` -- a regular expression on the kernel's name in the trace;
* ``record(*args, **kwargs)`` -- what the count needs of one launch's
  inputs, kept without waiting for the device;
* ``work(rec)`` -- (operations, bytes) that launch needs: each input byte
  read once and each output byte written once; operations counted from
  the inputs, whatever the kernel computes on top.

The bound of a launch is the larger of operations over their peak rate and
bytes over the memory's (``peaks``).
"""
