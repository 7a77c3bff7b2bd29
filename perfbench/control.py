"""The readings that the limits of ``perfbench/limits/<cell>.json`` are set
from: per seed, one unit of the cell's traffic, then the numbers of
``perfbench/checks.py`` for the program and for the control (the
reference in the program's place, computed in ``--dtype``, bfloat16 by
default: the precision below the program's float32).

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import checks, inputs
from .run import REPO, Cell, cache_env, entry_module, load_json


def readings(cell: Cell, seeds, device, dtype=torch.bfloat16):
    """Yields (seed, {"program": numbers, "control": numbers})."""
    entry_mod = entry_module(cell.traffic["entry"], cell.root)
    draft = inputs.draft_text(cell.cfg, cell.root)
    for seed in seeds:
        entry = entry_mod.Entry(cell.cfg, cell.traffic, draft, device)
        got = entry.unit(inputs.reads(cell.cfg, seed, 0, cell.root))
        t0 = time.perf_counter()
        nums = checks.numbers(entry_mod, entry, got, cell.cfg, cell.traffic,
                              seed, device, control=dtype)
        print(f"seed {seed}: reference and control {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)
        yield seed, nums
        del entry, got
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    cache_env()
    cell = Cell(args.workload, load_json(REPO / "BENCHMARK.json"))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    for seed, nums in readings(cell, args.seeds, device,
                               getattr(torch, args.dtype)):
        print(json.dumps({"seed": seed, **{
            v: {k: (x if abs(x) < float("inf") else str(x))
                for k, x in d.items()} for v, d in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
