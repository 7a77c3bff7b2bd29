"""The port's span recorder: :class:`StageTimes`, the time split and
counts of one k-stage or mapping pass, and :func:`span`, which names a
stretch of host time.

A span does nothing but check module state unless a collector is active
or ``torch.profiler`` is recording.  The collector is the
:class:`StageTimes` an entry point was given (``times=``), made active by
:func:`collecting` for the call.  With a collector a span reads the host
clock (``time.perf_counter_ns``) on entry and exit and adds its self time
(its duration less that of the spans opened inside it) to the
collector's field for its name (``SELF_FIELDS``), or its whole duration
(``DURATION_FIELDS``).  Under the profiler it also opens
``record_function(name)``, so that it appears in the exported chrome
trace as a ``user_annotation`` on the device's clock.  Spans read the
host clock only: they add no device synchronisation.

:func:`timer` sums a stretch of a loop into a field without being a span
(no annotation, not a parent); :func:`count` adds to a counter.

The span tree (``StageTimes`` field in brackets; self time except where
the duration is marked)::

    stage [wall_s, duration]             one k-stage, or the final pass
      map                                the outermost generate_mappings
        map.seed [seed_s, duration]      seed_mappings_arrays
          seed.index [seed_index_s]      the SeedIndex build
          (timers: seed_hits_s, seed_chain_s, seed_rows_s)
        map.prep [map_prep_s]            to_phmm, padding, puts
        map.launch [map_launch_s]        the decode's launches
        map.fetch [map_fetch_s]          the copy to the host
        map.gate [map_gate_s]            trim, per-read copies, the gate
      reinit [reinit_s]                  freqs, the guard, the MSE re-init
      sample                             sample_posterior
        sample.setup [setup_s, duration] the scorer's set-up
          setup.template [setup_template_s]    make_template
          setup.positions [setup_positions_s]  read and mapping pads,
                                               precompute_positions
          setup.streams [setup_streams_s]      the scorer's streams, sync
        sample.neighbors [neighbors_s, duration]  neighbour generation
          neighbors.network [neighbors_network_s]  copy numbers, the flow
                                               networks, residual graphs
          (timers: neighbors_paths_s, the shortest paths of a 0x edge;
           neighbors_cycles_s, cycles to flows and infos)
        sample.move [move_s]             dedup, multi-move, the choice
          sample.reads [score_s, duration]  the scorer
          sample.prior [prior_s]         genome size, Euler count, prior
      purge_extend [extend_s]            purge_and_extend_with_posterior

``map.prep``, ``map.launch`` and ``map.fetch`` also add to ``decode_s``
(a decode from scratch) or ``refine_s`` (a hinted one).  Every span but
``stage``, ``map`` and ``sample`` is named; ``untraced_s`` is the wall
time that no named span covers.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

from torch.autograd import profiler as _profiler

SELF_FIELDS = {
    "seed.index": "seed_index_s",
    "map.prep": "map_prep_s",
    "map.launch": "map_launch_s",
    "map.fetch": "map_fetch_s",
    "map.gate": "map_gate_s",
    "setup.template": "setup_template_s",
    "setup.positions": "setup_positions_s",
    "setup.streams": "setup_streams_s",
    "neighbors.network": "neighbors_network_s",
    "sample.prior": "prior_s",
    "sample.move": "move_s",
    "purge_extend": "extend_s",
    "reinit": "reinit_s",
}
DURATION_FIELDS = {
    "stage": "wall_s",
    "map.seed": "seed_s",
    "sample.setup": "setup_s",
    "sample.neighbors": "neighbors_s",
    "sample.reads": "score_s",
}
UNNAMED = ("stage", "map", "sample")  # they cover everything, name nothing


@dataclass
class StageTimes:
    """Wall-clock split and counts of one k-stage or mapping pass (host
    clock; spans add no device synchronisation, so device work shows
    where the host waits for it: ``map.fetch``, the scorer set-up's
    synchronise)."""

    k: int
    seed_s: float = 0.0  # seed_mappings_arrays (host)
    decode_s: float = 0.0  # from-scratch decodes (device) incl. transfers
    refine_s: float = 0.0  # mappings_refine (device) incl. transfers
    setup_s: float = 0.0  # template, positions, scorer streams
    score_s: float = 0.0  # read likelihoods of candidates (device)
    n_scorings: int = 0  # candidates x reads scored
    n_rescued: int = 0  # linear-space candidates rescored in log space
    wall_s: float = 0.0
    # seeding's parts: the index; then, summed over reads, the suffix
    # lookups, the chain DP, and the rows (the backfill and the block)
    seed_index_s: float = 0.0
    seed_hits_s: float = 0.0
    seed_chain_s: float = 0.0
    seed_rows_s: float = 0.0
    # the mapping's parts (prep + launch + fetch = decode_s + refine_s)
    map_prep_s: float = 0.0
    map_launch_s: float = 0.0
    map_fetch_s: float = 0.0
    map_gate_s: float = 0.0
    # the scorer set-up's parts (they sum to setup_s)
    setup_template_s: float = 0.0
    setup_positions_s: float = 0.0
    setup_streams_s: float = 0.0
    # the climb's parts and the stage's host steps; neighbour generation's
    # three phases (rescue, and the final pass's short, long and reducer
    # neighbourhoods alike) sum to neighbors_s
    neighbors_s: float = 0.0
    neighbors_network_s: float = 0.0
    neighbors_paths_s: float = 0.0
    neighbors_cycles_s: float = 0.0
    prior_s: float = 0.0
    move_s: float = 0.0
    extend_s: float = 0.0
    reinit_s: float = 0.0
    # counters
    reads: int = 0  # reads mapped
    reads_unseeded: int = 0  # reads with no exact suffix hit
    reads_gated: int = 0  # reads the refine's gate flagged
    fetch_bytes: int = 0  # mapping bytes copied to the host
    kept_bytes: int = 0  # of those, what the mappings keep
    climb_iters: int = 0  # moves taken
    candidates: int = 0  # neighbours generated
    candidates_scored: int = 0  # unique candidates scored
    edges_purged: int = 0
    zero_edges: int = 0  # 0x compact edges of the climb graph, per sweep
    rescue_paths: int = 0  # the rescue's k-shortest paths found for them
    seed_positions: int = 0  # read positions seeded (for seed_cover)
    seed_hit_positions: int = 0  # of those, with a candidate
    seed_rows_backfilled: int = 0  # empty rows the native backfill filled
    named_s: float = 0.0  # summed self time of the named spans

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        for key in ("seed_positions", "seed_hit_positions", "named_s"):
            del d[key]
        d["host_s"] = self.wall_s - (self.seed_s + self.decode_s + self.refine_s
                                     + self.setup_s + self.score_s)
        d["scorings_per_s"] = (self.n_scorings / self.score_s
                               if self.score_s > 0 else 0.0)
        d["seed_cover"] = self.seed_hit_positions / max(1, self.seed_positions)
        d["untraced_s"] = self.wall_s - self.named_s
        return d


_times: Optional[StageTimes] = None  # the active collector
_stack: list = []  # the open spans that read the clock, innermost last


class _Off:
    """What a span or timer is when it records nothing."""

    s = 0.0

    def __enter__(self):
        return self

    def elapsed(self) -> float:
        return 0.0

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "also", "times", "t0", "child", "s", "_rf")

    def __init__(self, name: str, also: Optional[str]):
        self.name, self.also, self.times = name, also, _times
        self.child, self.s, self._rf = 0, 0.0, None

    def __enter__(self):
        # the annotation's cost falls inside the span's own time, not its
        # parent's, so that a span's parts still sum to it under the profiler
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def elapsed(self) -> float:
        """Seconds since the span opened."""
        return (time.perf_counter_ns() - self.t0) * 1e-9

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        dur = time.perf_counter_ns() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child += dur
        self.s = dur * 1e-9
        t = self.times
        if t is not None:
            own = (dur - self.child) * 1e-9
            field = SELF_FIELDS.get(self.name)
            if field is not None:
                setattr(t, field, getattr(t, field) + own)
            field = DURATION_FIELDS.get(self.name)
            if field is not None:
                setattr(t, field, getattr(t, field) + self.s)
            if self.also is not None:
                setattr(t, self.also, getattr(t, self.also) + own)
            if self.name not in UNNAMED:
                t.named_s += own
        return False


def span(name: str, also: Optional[str] = None, clock: bool = False):
    """A context manager naming a stretch of host time ``name``.  ``also``
    names a further field that receives its self time; ``clock=True``
    reads the clock even with nothing recording, for a caller that reads
    the span's ``s`` (seconds, after it closes) or ``elapsed()``."""
    if _times is None and not clock and not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, also)


def outermost(name: str):
    """``span(name)``, or nothing where a span of that name is open."""
    return OFF if is_open(name) else span(name)


def is_open(name: str) -> bool:
    """Whether a span ``name`` that reads the clock is open."""
    return any(sp.name == name for sp in _stack)


@contextlib.contextmanager
def collecting(times: Optional[StageTimes]):
    """Make ``times`` the active collector for the block (nothing changes
    when it is None)."""
    global _times
    if times is None or times is _times:
        yield
        return
    saved, _times = _times, times
    try:
        yield
    finally:
        _times = saved


class _Timer:
    __slots__ = ("times", "field", "t0")

    def __init__(self, times: StageTimes, field: str):
        self.times, self.field = times, field

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter_ns() - self.t0) * 1e-9
        setattr(self.times, self.field, getattr(self.times, self.field) + dt)
        return False


def timer(field: str):
    """Add the block's duration to the collector's ``field`` (nothing
    without a collector)."""
    return OFF if _times is None else _Timer(_times, field)


def count(field: str, n: int = 1) -> None:
    """Add ``n`` to the collector's counter ``field``."""
    if _times is not None:
        setattr(_times, field, getattr(_times, field) + n)
