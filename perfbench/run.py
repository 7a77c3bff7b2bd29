"""Run one cell of the port's benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``perfbench/configs/``, its inputs under ``perfbench/data/``) and a
traffic mix (``perfbench/traffic/<name>.json``: its entry, the file
``perfbench/entries/<entry>.py`` that runs a unit and checks it, and the
entry's parameters); its limits are ``perfbench/limits/<cell>.json``.  Metrics are
read by ``perfbench/metrics/<name>.py``, kernel work counted by
``perfbench/roofline/<kernel>.py``.

Set-up: CUDA, the program's libraries (built into its checkout on the
first run), the inputs from ``--seed`` and one whole warm unit.  The
window then runs whole units and ends with the first unit that ends at or
after ``--seconds``; every metric divides by the window's whole length.
``--trace 1`` runs the window under ``torch.profiler`` with the
benchmark's spans and reports the per-layer metrics instead of the
end-to-end ones.  After the window, one unit drawn from the seed is
compared with the float64 reference (``perfbench/checks.py``).

The last line of standard output is the result (JSON); the numbers
compared, each with its limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dbgphmm_tpu"}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metrics, all found by name."""

    def __init__(self, name: str, bench: dict, root: Path = ROOT):
        ws = {w["name"]: w for w in bench["workloads"]}
        if name not in ws:
            raise SystemExit(f"unknown workload {name!r}")
        w = ws[name]
        self.name, self.root = name, root
        cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        self.cfg = load_json(root.parent / cfg_entry["file"])
        self.traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")
        self.chips = int(w["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.e2e = [m for m in bench["end_to_end"] if mine(m)]
        names = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in bench["per_layer"]
                          if mine(m) and m["moves"] in names]


class Context:
    """What a metric reader can read of one run."""

    def __init__(self, entry: str, setup_s: float, window_s: float,
                 work: int, stage_times=None, trace=None, launches=None,
                 rooflines=None):
        self.entry, self.setup_s, self.window_s = entry, setup_s, window_s
        self.work = work
        self.stage_times = stage_times or []
        self.trace, self.launches = trace, launches or {}
        self.rooflines = rooflines or {}

    def per_stage(self, field: str):
        if not self.stage_times:
            return None
        return sum(st[field] for st in self.stage_times) / len(self.stage_times)

    def roofline_pct(self, kid: str):
        from .roofline import peaks

        rl, recs = self.rooflines.get(kid), self.launches.get(kid)
        if self.trace is None or rl is None or not recs:
            return None
        t = self.trace.kernel_s(rl.KERNEL)
        if t <= 0:
            return None
        return 100.0 * sum(peaks.bound_s(*rl.work(r)) for r in recs) / t

    def idle_pct(self):
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def entry_module(name: str, root: Path = ROOT):
    """``perfbench/entries/<name>.py``: a traffic entry's unit and checks."""
    path = root / "entries" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"unknown traffic entry {name!r}: no {path}")
    return load_module(path)


def rooflines(root: Path = ROOT) -> dict:
    return {p.stem: load_module(p) for p in sorted((root / "roofline").glob("*.py"))
            if p.stem not in ("__init__", "peaks")}


def read_metrics(specs, ctx: Context, root: Path = ROOT) -> dict:
    out = {}
    for m in specs:
        v = load_module(root / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_report() -> str:
    """nvidia-smi's view of the card and of every compute process on it."""
    q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
         "temperature.gpu", "--format=csv,noheader"]
    p = ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"]
    try:
        card = subprocess.run(q, capture_output=True, text=True, timeout=30)
        apps = subprocess.run(p, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (f"card: {card.stdout.strip()}\n"
            f"compute processes: {apps.stdout.strip() or 'none'}")


def host_state():
    """(1-minute load average, seconds of CPU stolen from this machine)."""
    try:
        with open("/proc/stat") as f:
            cols = f.readline().split()
        steal = int(cols[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        steal = float("nan")
    return os.getloadavg()[0], steal


def _num(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """Set up, warm, measure, check; the result line as a dict."""
    import torch

    from . import checks, inputs, program, trace as T

    device = torch.device(device)
    entry_mod = entry_module(cell.traffic["entry"], cell.root)
    entry = entry_mod.Entry(cell.cfg, cell.traffic,
                            inputs.draft_text(cell.cfg, cell.root), device)
    # one read set per unit: the warm-up's, then the window's in turn
    pool = [inputs.reads(cell.cfg, seed, j, cell.root)
            for j in range(1 + int(cell.traffic["read_sets"]))]
    entry.unit(pool[0])  # warm-up: the libraries built, every kernel run
    rng = np.random.default_rng([int(seed), 2])

    rls = rooflines(cell.root) if traced else {}
    recorder = program.LaunchRecorder(rls)
    patches, prof, span = [], None, None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        span = record_function
        patches = program.span_patches(span) + recorder.patches()
        entry.stage_times = []
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    # what set-up left is kept out of the window's garbage collections
    gc.collect()
    gc.freeze()
    host0 = host_state()
    setup_s = time.perf_counter() - T_START
    kept, units, work, failed, ends, cpu = None, 0, 0, 0, [], []
    with (prof or contextlib.nullcontext()), program.patched(patches), \
            (span("window") if span else contextlib.nullcontext()):
        t0, c0 = time.perf_counter(), time.process_time()
        while True:
            got = entry.unit(pool[1 + units % (len(pool) - 1)])
            units += 1
            work += got["work"]
            failed += got["failed"]
            if rng.random() * units < 1.0:  # one unit drawn from the seed
                kept = got
            got = None
            ends.append(time.perf_counter() - t0)
            cpu.append(time.process_time() - c0)
            if ends[-1] >= seconds:
                break
        window_s = time.perf_counter() - t0
    host1 = host_state()
    gc.unfreeze()
    bad = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    tr = None
    if traced:
        path = T.trace_path(cell.name, seed)
        prof.export_chrome_trace(str(path))
        tr = T.Trace(path, program.SPANS)
        log(f"trace: {path} ({path.stat().st_size} bytes)")
    ctx = Context(cell.traffic["entry"], setup_s, window_s, work,
                  entry.stage_times, tr, recorder.launches, rls)
    metrics = read_metrics(cell.per_layer if traced else cell.e2e, ctx,
                           cell.root)
    log(f"window: {units} units, {work} {entry.work_unit}, "
        f"{window_s:.3f} s; setup {setup_s:.3f} s; peak {peak} bytes; "
        f"launches {({k: len(v) for k, v in recorder.launches.items()})}; "
        f"unit s {[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]}; "
        f"unit cpu s {[round(b - a, 3) for a, b in zip([0.0] + cpu, cpu)]}")
    if entry.notes:
        log(f"units: {entry.notes[1:]}")  # the first is the warm-up's
    log(f"host: load {host0[0]:.2f} -> {host1[0]:.2f}, steal "
        f"{host1[1] - host0[1]:.2f} s in the window, "
        f"{len(os.sched_getaffinity(0))} cpus, torch threads "
        f"{torch.get_num_threads()}, native seeding "
        f"{getattr(sys.modules.get(program.PACKAGE + '.multi_dbg.seed'), '_SEED_LIB', None) is not None}")

    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    values = checks.numbers(entry_mod, entry, kept, cell.cfg, cell.traffic,
                            seed, device)["program"]
    log(f"reference: {time.perf_counter() - t1:.3f} s")
    correct = checks.judge(values, cell.limits)
    result = {
        "correct": bool(correct), "attempted": work, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    for k in sorted(set(values) - set(cell.limits)):
        log(f"reading {k} {values[k]!r} (no limit: not compared)")
    result["checks"] = {k: {"value": _num(values.get(k)), "limit": lim}
                        for k, lim in cell.limits.items()}
    for k, lim in cell.limits.items():
        log(f"check {k} {values.get(k)!r} limit {lim!r}")
    return result


def cache_env() -> None:
    """Kernel and build caches inside the checkout, at fixed paths."""
    cache = ROOT / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(cache / sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = Cell(args.workload, load_json(REPO / "BENCHMARK.json"))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(card_report(), file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
