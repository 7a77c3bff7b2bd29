"""StageTimes.neighbors_cycles_s (its timer: the edge-simple test,
the paths as cycles and flows, their infos; in the final pass the short
and reducer cycles too), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "neighbors_cycles_s")
