"""Hold two logs of ``sim-infer`` stage by stage: a run of the port (the log
``dbgphmm_tpu_torch/scripts/sim.sh supervise`` writes) against a run of the
JAX package (``scripts/sim.sh``'s log, e.g. ``runs_n5_launch.log``).  Both
packages print the same climb and stage lines.

Usage: python dbgphmm_tpu_torch/scripts/compare_run_logs.py <port.log> <jax.log> [--rel 1e-5]

Per k it prints one row with, for each side: the climb's accepted moves,
the iteration of the local optimum, the posterior's sample count, the last
``moved to p`` value, whether the stage's mappings were refined or
regenerated, and whether the purge into this k lost a true path.  A stage
agrees when both sides made the same moves (the same ``via [...]`` text)
with every ``moved to p`` within ``--rel`` relative, reached the local
optimum at the same iteration and drew the same number of samples.  A
stage a supervisor restarted keeps its first attempt; the row says how many
attempts each side made.  The last line names the first stage that parts.
"""

import re
import sys

MOVE = re.compile(r"\[posterior\] moved to p=(-?[\d.]+|-?inf) via (.*)$")


def parse(path):
    """k -> list of attempts, each a dict: moves [(p, via)], opt (the
    iteration of the local optimum), samples, maps ("refined" /
    "regenerated" for the mapping pass that led into k), truth_lost."""
    stages = {}
    cur = {"moves": [], "opt": None}
    into = {"maps": None, "truth_lost": False}
    for line in open(path, errors="replace"):
        line = line.rstrip("\n")
        m = MOVE.search(line)
        if m:
            cur["moves"].append((float(m.group(1)), m.group(2)))
            continue
        m = re.search(r"\[posterior\] iter (\d+): local optimum", line)
        if m:
            cur["opt"] = int(m.group(1))
            continue
        m = re.search(r"\[infer\] k=(\d+) posterior sampled in [\d.]+s "
                      r"\((\d+) samples\)", line)
        if m:
            att = dict(cur, samples=int(m.group(2)), **into)
            stages.setdefault(int(m.group(1)), []).append(att)
            cur = {"moves": [], "opt": None}
            into = {"maps": None, "truth_lost": False}
            continue
        if "[infer] TRUTH LOST" in line:
            into["truth_lost"] = True
        m = re.search(r"\[infer\] mappings (refined|regenerated) in", line)
        if m:
            into["maps"] = m.group(1)
        if re.search(r"# (supervise|run_dbgphmm): rc=\d+ attempt=", line):
            cur = {"moves": [], "opt": None}
            into = {"maps": None, "truth_lost": False}
    return stages


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def compare(port, ref, rel):
    """One row per k both logs hold, and the first k where they part."""
    rows, first = [], None
    for k in sorted(set(port) & set(ref)):
        a, b = port[k][0], ref[k][0]
        same_moves = [v for _p, v in a["moves"]] == [v for _p, v in b["moves"]]
        drel = max((_rel(pa, pb) for (pa, _), (pb, _) in
                    zip(a["moves"], b["moves"])), default=0.0)
        ok = (same_moves and drel <= rel and a["opt"] == b["opt"]
              and a["samples"] == b["samples"])
        if not ok and first is None:
            first = k
        rows.append((k, a, b, len(port[k]), len(ref[k]), same_moves, drel, ok))
    return rows, first


def _side(s, n_att):
    p = f"{s['moves'][-1][0]:.3f}" if s["moves"] else "-"
    return (f"{len(s['moves'])} | {s['opt']} | {s['samples']} | {p} | "
            f"{s['maps'] or '-'}{' TRUTH LOST' if s['truth_lost'] else ''}"
            f"{f' ({n_att} attempts)' if n_att > 1 else ''}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rel = 1e-5
    if "--rel" in argv:
        i = argv.index("--rel")
        rel = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    port, ref = parse(argv[0]), parse(argv[1])
    rows, first = compare(port, ref, rel)
    print("| k | port moves | opt | samples | last p | mappings "
          "| JAX moves | opt | samples | last p | mappings "
          "| same moves | max rel p diff | agree |")
    print("|" + "---|" * 14)
    for k, a, b, na, nb, same, drel, ok in rows:
        print(f"| {k} | {_side(a, na)} | {_side(b, nb)} | "
              f"{'yes' if same else 'no'} | {drel:.3g} | "
              f"{'yes' if ok else 'no'} |")
    print(f"# stages compared={len(rows)} (port {len(port)}, JAX {len(ref)}) "
          f"rel={rel:g} first parting k={first if first is not None else 'none'}")
    return rows, first


if __name__ == "__main__":
    main()
