"""Traffic entry ``infer``: ``multi_dbg.posterior.infer_posterior_by_extension``
from the draft to ``k_max`` with ``max_iter`` climb moves per k-stage, and
the final full-neighbourhood pass -- what ``sim-infer`` / ``infer`` run
per stage, without their file output.  Work: the k-stages completed.

Its numbers, for each k-stage of the unit (the widest over stages and
reads):

* ``decode_ll_rel`` -- a read's log-likelihood from a decode from scratch
  (A1, R2) against the reference's full forward, relative;
* ``refine_ll_rel`` -- the same for a refined stage (R1, R2), against the
  reference's forward restricted to the sets the refine was given (the
  hint), or its full forward for a read the refine's gate sent back to a
  decode from scratch.  A seeded map (a call without a hint that refined
  its own seeded sets, above 32,768 full edges) never sends a read back,
  so there every read is held to its seeded sets' forward;
* ``post_gap`` -- the mapping's per-base sets against the reference's
  posteriors of the same decode (``perfbench.checks.set_gap``);
* ``score_rel`` -- a candidate's total read log-likelihood from the scorer
  (K1) against the reference's forward of the candidate's copy numbers over
  the mapping's sets, for the chosen copy numbers and up to
  ``check_candidates`` others drawn from the seed;
* ``host_gap`` -- |prior + log Euler count from the program - from the
  reference| over the same candidates (nats);
* ``extend_faults`` -- (k+1)-mers of the next stage's graph that no two
  adjacent k-mers join, plus joins of positive-copy k-mers it lacks;
* readings: ``set_loss``, the reference's full forward (in a seeded
  stage, its forward over the seeded sets) minus its forward restricted to
  the mapping's sets (nats); ``seed_loss``, in a seeded stage only, the
  full forward minus the seeded sets' forward on ``SEED_CHECK_READS``
  reads drawn from the seed, the longest among them (nats: what seeding
  misses; the largest float for a read whose seeded set is empty);
  ``climb_margin``, the most by which a drawn candidate's reference score
  beats the chosen.

In a seeded stage the full forward over every read, which held no limit
there, is not run: at a KIR-class locus it took most of the check's time.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from perfbench import checks, program
from perfbench.reference import graph as G
from perfbench.reference import phmm as P

# reads a seeded stage runs the full forward over, for ``seed_loss``
SEED_CHECK_READS = 4


class Entry(program.Entry):
    work_unit = "stages"

    def unit(self, reads: List[bytes]) -> dict:
        s, t = self.cfg["settings"], self.traffic
        stages, calls = [], []
        times = [] if self.stage_times is not None else None

        def on_iter(dbg, posterior, _paths, mappings):
            stages.append((dbg, posterior, mappings))

        gm = self.posterior.generate_mappings
        with program.patched([(self.posterior, "generate_mappings",
                               program.recording(calls, gm))]):
            dbg, posterior, _paths, mappings = \
                self.posterior.infer_posterior_by_extension(
                    k_max=int(t["k_max"]), dbg_init=self.draft,
                    param_infer=self.PHMMParams.uniform(s["p_infer"]),
                    param_error=self.PHMMParams.uniform(s["p_error"]),
                    reads=reads,
                    genome_size_expected=int(s["genome_size"]),
                    genome_size_sigma=int(s["genome_size_sigma"]),
                    device=self.device, max_iter=int(s["max_iter"]),
                    p0=float(s["p0"]), on_iter=on_iter, stage_times=times)
        stages.append((dbg, posterior, mappings))
        program.sync(self.device)
        if times is not None:
            self.stage_times += [st.as_dict() for st in times]
        failed = sum(1 for _d, post, _m in stages
                     if not np.isfinite(post.max_sample().score.p()))
        return {"work": len(stages), "failed": failed, "stages": stages,
                "calls": calls, "reads": reads}


def _seeded(calls: list, mappings) -> bool:
    """Whether ``mappings`` came from a call without a hint that made an
    inner call with its seeded sets: the program refines those with
    ``hint_regen=False`` and re-decodes no read from scratch."""
    hints = [h is not None for _c, h, out in calls if out is mappings]
    return any(hints) and not all(hints)


def _posteriors(g, p_err, reads, codes, lens, hint, gated, dtype):
    """[(read indices, reference nodes, log S, log-likelihoods)] of the
    stage's decode in ``dtype``: over the hint's sets for every read, or
    from scratch without a hint; then from scratch for the reads the gate
    sent back (``gated``, with a hint)."""
    sets = None if hint is None else checks.sets_array(hint, codes.shape[1],
                                                       codes.device)
    out = [(np.arange(len(reads)),
            *checks.posteriors(g, p_err, codes, lens, sets, dtype))]
    idx = np.flatnonzero(gated) if hint is not None else []
    if len(idx):
        c, ln = P.encode([reads[j] for j in idx], codes.device)
        out.append((idx, *checks.posteriors(g, p_err, c, ln, None, dtype)))
    return out


def _own(parts, gated, hint):
    """(part, the reads it decides, their rows in it): each read goes by
    its own mode, a gated read by the decode from scratch."""
    for k, (idx, *_rest) in enumerate(parts):
        keep = idx if k or hint is None else idx[~gated]
        if len(keep):
            yield parts[k], keep, np.searchsorted(idx, keep)


def numbers(entry: Entry, captured: dict, cfg: dict, traffic: dict,
            rng: np.random.Generator, device,
            control: Optional[torch.dtype] = None) -> dict:
    stages, calls, reads = (captured["stages"], captured["calls"],
                            captured["reads"])
    s = cfg["settings"]
    p_err, p_inf = P.Params(s["p_error"]), P.Params(s["p_infer"])
    codes, lens = P.encode(reads, device)
    variants = {"program": torch.float64}
    if control is not None:
        variants["control"] = control
    outs = {v: {"decode_ll_rel": 0.0, "refine_ll_rel": 0.0, "post_gap": 0.0,
                "score_rel": 0.0, "host_gap": 0.0, "extend_faults": 0,
                "set_loss": 0.0, "climb_margin": 0.0} for v in variants}
    graphs = []
    last = len(stages) - 1
    mu, sigma = float(s["genome_size"]), float(s["genome_size_sigma"])
    for i, (dbg, post, maps) in enumerate(stages):
        # the mapping saw the graph's copy numbers of its call; the climb
        # starts from the stage's first sample
        copies, hint = program.call_of(calls, maps)
        seeded = _seeded(calls, maps)
        g = program.graph_of(dbg, copies)
        gs = program.graph_of(dbg, post.samples[0].copy_nums)
        graphs.append((gs, post.max_copy_nums()))
        # candidates: the chosen and some drawn from the seed
        chosen = post.max_sample()
        others = [x for x in post.samples if x is not chosen]
        k = min(int(traffic["check_candidates"]), len(others))
        cands = [chosen] + [others[j] for j in sorted(
            rng.choice(len(others), k, replace=False))]
        p_sc = p_inf if i < last else p_err
        # the decode's own reference, over the hint or from scratch (whose
        # forward is the full one)
        n = len(reads)
        ll = np.asarray(maps.read_logps, dtype=np.float64)
        gated = np.zeros(n, dtype=bool)
        ref = _posteriors(g, p_err, reads, codes, lens, hint, gated,
                          torch.float64)
        within = ref[0][3]
        # the full forward (where the refine's gate could send a read
        # back), the forward over the mapping's sets and each candidate's,
        # in one scan a dtype
        gate = hint is not None and not seeded
        specs = [(None, p_err)] + [(c.copy_nums, p_sc) for c in cands]
        sets_rows = [maps.nodes] * (1 + len(cands))
        if gate:
            specs, sets_rows = [(None, p_err)] + specs, [None] + sets_rows
        res = {v: checks.rows(g, specs, sets_rows, codes, lens, dt)
               for v, dt in variants.items()}
        base = int(gate)
        dense = res["program"][0] if gate else within
        restricted = res["program"][base]
        if gate:
            # a read the refine's gate sent back was decoded from scratch
            gated = np.abs(ll - dense) < np.abs(ll - within)
            if gated.any():
                ref = _posteriors(g, p_err, reads, codes, lens, hint, gated,
                                  torch.float64)
        if seeded:
            # what seeding misses, on a few reads: the full forward
            few = _drawn(reads, rng)
            c, ln = P.encode([reads[j] for j in few], device)
            full = checks.rows(g, [(None, p_err)], [None], c, ln)[0]
            for v in variants:
                max_into(outs, v, "seed_loss", checks.loss(full, within[few]))
        got = {"program": (ll, maps.nodes, maps.logps)}
        for v, dt in variants.items():
            if v == "program":
                continue
            c_ll = np.empty(n)
            c_sets, c_logs = [None] * n, [None] * n
            parts = _posteriors(g, p_err, reads, codes, lens, hint, gated, dt)
            for (idx, nodes, log, cll), keep, sel in _own(parts, gated, hint):
                nd, lg = checks.select_lists(nodes, log,
                                             [len(reads[j]) for j in idx])
                for a, j in zip(sel, keep):
                    c_ll[j], c_sets[j], c_logs[j] = cll[a], nd[a], lg[a]
            got[v] = (c_ll, c_sets, c_logs)
            del parts
        for v, (x, sets, logps) in got.items():
            for (_idx, nodes, log, _ll), keep, sel in _own(ref, gated, hint):
                at = torch.as_tensor(sel, device=device)
                max_into(outs, v, "post_gap", checks.set_gap(
                    [sets[j] for j in keep], [logps[j] for j in keep],
                    nodes[at], log[at]))
            if hint is None:
                max_into(outs, v, "decode_ll_rel", checks.gap(x, dense))
            elif not gate:
                max_into(outs, v, "refine_ll_rel", checks.gap(x, within))
            else:
                max_into(outs, v, "refine_ll_rel", float(np.minimum(
                    [checks.gap(a, b) for a, b in zip(x, within)],
                    [checks.gap(a, b) for a, b in zip(x, dense)]).max(
                        initial=0.0)))
            max_into(outs, v, "set_loss", checks.loss(dense, restricted))
        # and the loops' last tables, so that none outlives its stage
        del ref, nodes, log
        # the scorer leaves out reads whose mapping is empty
        alive = np.asarray([(n >= 0).any() for n in maps.nodes])
        ref_ll = res["program"][base + 1:, alive].sum(axis=1)
        ref_host = checks.host(gs, cands, mu, sigma)
        ref_p = ref_ll + ref_host
        got_ll = {"program": np.asarray([c.score.likelihood for c in cands])}
        got_host = {"program": np.asarray([c.score.prior
                                           + c.score.n_euler_circuits
                                           for c in cands])}
        pick = {"program": 0}  # the climb's choice among the candidates
        if control is not None:
            got_ll["control"] = res["control"][base + 1:, alive].sum(axis=1)
            got_host["control"] = checks.host(gs, cands, mu, sigma, np.float32)
            ctl_p = np.nan_to_num(got_ll["control"] + got_host["control"],
                                  nan=-np.inf)
            pick["control"] = int(np.argmax(ctl_p))
        for v in variants:
            max_into(outs, v, "score_rel", checks.gap(got_ll[v], ref_ll))
            max_into(outs, v, "host_gap",
                     checks.gap(got_host[v], ref_host, False))
        best = np.nan_to_num(ref_p, nan=-np.inf).max()
        for v, j in pick.items():
            max_into(outs, v, "climb_margin",
                     float(np.nan_to_num(best - ref_p[j], nan=np.inf)))
    # k+1 extension between consecutive stages whose k grows
    for (g0, cn0), (g1, _), (dbg1, _, _) in zip(graphs, graphs[1:], stages[1:]):
        if dbg1.k == g0.k + 1:
            g0.copy = np.asarray(cn0, dtype=np.int64)[g0.full_to_compact]
            faults = G.extension_faults(g0, g1)
            for v in variants:
                outs[v]["extend_faults"] += faults
    return outs


def _drawn(reads: List[bytes], rng: np.random.Generator) -> np.ndarray:
    """``SEED_CHECK_READS`` read indices drawn from the seed, the longest
    among them, in read order."""
    n = min(SEED_CHECK_READS, len(reads))
    longest = int(np.argmax([len(r) for r in reads]))
    rest = [j for j in range(len(reads)) if j != longest]
    return np.asarray(sorted([longest] + list(
        rng.choice(rest, n - 1, replace=False))))


def max_into(outs: dict, v: str, key: str, x) -> None:
    outs[v][key] = max(outs[v].get(key, x), x)
