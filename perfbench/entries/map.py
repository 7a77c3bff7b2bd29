"""Traffic entry ``map``: ``multi_dbg.posterior.generate_mappings`` of
every read on the draft, no hint -- the ``mapping`` command.  Above 32,768
full edges that is exact-match seeding, then the refine (R1, R2) over the
seeded sets; below, a decode from scratch.  Work: the reads mapped.

Its numbers, on ``check_reads`` reads drawn from the seed (the longest
among them), against the reference's decode over the same cells (the
seeded sets, or from scratch):

* ``map_ll_rel`` -- a read's log-likelihood, relative;
* ``post_gap`` -- its per-base sets (``perfbench.checks.set_gap``);
* readings: ``set_loss``, what the output sets leave out of the
  reference's forward over the seeded sets (nats), and ``seed_loss``, what
  the seeded sets leave out of the full forward.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from perfbench import checks, program
from perfbench.reference import phmm as P


class Entry(program.Entry):
    work_unit = "reads"

    def unit(self, reads: List[bytes]) -> dict:
        s = self.cfg["settings"]
        # the mapping's split adds no device synchronisation here: read it
        # in every run, for the per-unit log
        times = self.posterior.StageTimes(k=self.draft.k)
        calls = []
        gm = program.recording(calls, self.posterior.generate_mappings)
        t0 = time.perf_counter()
        with program.patched([(self.posterior, "generate_mappings", gm)]):
            mappings = gm(self.draft, self.PHMMParams.uniform(s["p_error"]),
                          reads, self.device, times=times)
        program.sync(self.device)
        times.wall_s = time.perf_counter() - t0
        self.notes.append({"seed_s": round(times.seed_s, 3),
                           "refine_s": round(times.refine_s, 3)})
        if self.stage_times is not None:
            self.stage_times.append(times.as_dict())
        failed = int((~np.isfinite(mappings.read_logps)).sum())
        return {"work": len(reads), "failed": failed,
                "mappings": mappings, "calls": calls, "reads": reads}


def numbers(entry: Entry, captured: dict, cfg: dict, traffic: dict,
            rng: np.random.Generator, device,
            control: Optional[torch.dtype] = None) -> dict:
    reads, mappings = captured["reads"], captured["mappings"]
    n = min(int(traffic["check_reads"]), len(reads))
    longest = int(np.argmax([len(r) for r in reads]))
    rest = [j for j in range(len(reads)) if j != longest]
    idx = sorted([longest] + list(rng.choice(rest, n - 1, replace=False)))
    codes, lens = P.encode([reads[j] for j in idx], device)
    copies, seeds = program.call_of(captured["calls"], mappings)
    g = program.graph_of(entry.draft, copies)
    p_err = P.Params(cfg["settings"]["p_error"])
    out_sets = [mappings.nodes[j] for j in idx]
    # below the seeded regime the map is a decode from scratch
    seed_sets = (None if seeds is None else checks.sets_array(
        [seeds[j] for j in idx], codes.shape[1], device))
    ref_nodes, ref_log, within = checks.posteriors(g, p_err, codes, lens,
                                                   seed_sets)
    dense, restricted = checks.rows(g, [(None, p_err)] * 2, [None, out_sets],
                                    codes, lens)
    got = {"program": (np.asarray(mappings.read_logps, dtype=np.float64)[idx],
                       out_sets, [mappings.logps[j] for j in idx])}
    if control is not None:
        c_nodes, c_log, c_ll = checks.posteriors(g, p_err, codes, lens,
                                                 seed_sets, control)
        got["control"] = (c_ll, *checks.select_lists(
            c_nodes, c_log, [len(reads[j]) for j in idx]))
        del c_nodes, c_log
    out = {}
    for v, (ll, sets, logps) in got.items():
        out[v] = {"map_ll_rel": checks.gap(ll, within),
                  "post_gap": checks.set_gap(sets, logps, ref_nodes, ref_log),
                  "set_loss": checks.loss(within, restricted),
                  "seed_loss": checks.loss(dense, within)}
    return out
