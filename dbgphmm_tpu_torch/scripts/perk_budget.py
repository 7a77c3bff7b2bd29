"""Parse a supervised run's log of the port into a per-k wall-budget table
(the counterpart of scripts/perk_budget.py).

Usage: python dbgphmm_tpu_torch/scripts/perk_budget.py <PRE.log> [--md]

The log is the one ``dbgphmm_tpu_torch/scripts/sim.sh supervise`` appends
to.  One row per k-stage with the measured phase costs:
  k, sampling_s, n_samples, seed_s, setup_s, extend_s, next_k,
plus run-level totals and restart counts.  The port measures the scorer's
positions and streams as one setup time (its ``[posterior] setup:`` line,
the ``setup_s`` of the ``# stage {json}`` lines a finished run prints), so
``setup_s`` stands where the JAX tool has ``positions_s`` and
``streams_s``.  A value the log does not hold prints ``-``.
"""

import re
import sys

COLS = ["sampling_s", "n_samples", "seed_s", "setup_s", "extend_s",
        "next_k"]


def parse(path):
    stages = {}  # k -> dict
    restarts = 0
    truth_events = []
    cur = {}
    for line in open(path, errors="replace"):
        m = re.search(r"\[seed\] (\d+) reads seeded in ([\d.]+)s", line)
        if m:
            cur["seed_s"] = float(m.group(2))
        m = re.search(r"\[posterior\] setup: .* ([\d.]+)s$", line.rstrip())
        if m:
            cur["setup_s"] = float(m.group(1))
        m = re.search(
            r"\[infer\] k=(\d+) posterior sampled in ([\d.]+)s \((\d+) "
            r"samples\)", line)
        if m:
            k = int(m.group(1))
            st = stages.setdefault(k, {})
            st.update(cur)
            # a restarted stage resamples the same k: keep the later values
            st["sampling_s"] = float(m.group(2))
            st["n_samples"] = int(m.group(3))
            cur = {}
        m = re.search(r"\[infer\] extended to k=(\d+) in ([\d.]+)s", line)
        if m:
            prev = max(stages) if stages else None
            if prev is not None:
                stages[prev]["extend_s"] = float(m.group(2))
                stages[prev]["next_k"] = int(m.group(1))
        if "TRUTH LOST" in line or "TRUTH-PURGE" in line:
            truth_events.append(line.strip())
        if re.search(r"# supervise: rc=\d+ attempt=", line):
            restarts += 1
    return stages, restarts, truth_events


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    md = "--md" in argv
    stages, restarts, truth_events = parse(path)
    if md:
        print("| k | " + " | ".join(COLS) + " |")
        print("|" + "---|" * (len(COLS) + 1))
    total = 0.0
    for k in sorted(stages):
        st = stages[k]
        total += sum(st.get(c, 0.0) for c in COLS
                     if c.endswith("_s") and isinstance(st.get(c), float))
        row = [str(st.get(c, "-")) for c in COLS]
        if md:
            print(f"| {k} | " + " | ".join(row) + " |")
        else:
            print(f"k={k} " + " ".join(f"{c}={v}" for c, v in zip(COLS, row)))
    jump = [f"{k}->{st['next_k']}" for k, st in sorted(stages.items())
            if st.get("next_k", k + 1) > k + 1]
    print(f"# stages={len(stages)} restarts={restarts} "
          f"measured_phase_total={total/60:.1f}min multi-k jumps: "
          f"{', '.join(jump) if jump else 'none'}")
    for t in truth_events[:10]:
        print(f"# {t}")


if __name__ == "__main__":
    main()
