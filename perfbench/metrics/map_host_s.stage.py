"""StageTimes.map_prep_s + StageTimes.map_gate_s (the mapping's host work: the
PHMM, padding and puts (`map.prep`), the trim, per-read copies and gate
(`map.gate`)), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "map_prep_s", "map_gate_s")
