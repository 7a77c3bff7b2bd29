"""The traced run: ``torch.profiler`` over the measured window, its chrome
trace written under the run's ``TMPDIR``, and what the benchmark reads
from it.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  ``busy_s`` is the union of their intervals inside
the window (the benchmark's own ``window`` annotation); the idle share is
1 - busy / window.  Each idle stretch is charged to the benchmark's spans
(``program.SPANS``, recorded as annotations on the same clock) that cover
it, the rest to ``host_other``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(cell: str, seed: int) -> Path:
    """``$TMPDIR/perfbench/<cell>.<seed>.trace.json``."""
    d = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "perfbench"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{cell}.{seed}.trace.json"


def short_name(name: str) -> str:
    """A kernel's function name: the identifier before its first template
    argument list or parameter list; a copy or fill as the trace names
    it."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    last = None
    for tok in re.finditer(r"[A-Za-z_][A-Za-z0-9_]*|[<(]",
                           name.replace("(anonymous namespace)", "")):
        if tok.group() in "<(":
            return last or name
        last = tok.group()
    return name


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """The events of one exported trace (times in seconds)."""

    def __init__(self, path: Path, span_names):
        events = json.loads(Path(path).read_text())["traceEvents"]
        self.device = []  # (start, end, name)
        self.spans = []  # (start, end, name)
        self.window = None
        names = set(span_names)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            a = float(ev["ts"]) * 1e-6
            b = a + float(ev.get("dur", 0.0)) * 1e-6
            cat, name = ev.get("cat", ""), ev.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((a, b, name))
            elif cat == "user_annotation":
                if name == "window":
                    self.window = (a, b)
                elif name in names:
                    self.spans.append((a, b, name))
        if self.window is None:
            raise RuntimeError(f"{path}: no window annotation")
        w0, w1 = self.window
        self.device = [(max(a, w0), min(b, w1), n) for a, b, n in self.device
                       if b > w0 and a < w1]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        return _union([(a, b) for a, b, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n))

    def device_ops(self, top: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            tot[short_name(n)] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the window by the span that was open."""
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        spans = sorted(self.spans)
        starts = [s[0] for s in spans]
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            covered = []
            for s0, s1, name in spans[: bisect.bisect_left(starts, b)]:
                lo, hi = max(a, s0), min(b, s1)
                if hi > lo:
                    covered.append((lo, hi))
                    tot[name] += hi - lo
            tot["host_other"] += (b - a) - sum(y - x for x, y in _union(covered))
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]
                if v > 0]
