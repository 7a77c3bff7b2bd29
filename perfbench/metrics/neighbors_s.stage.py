"""StageTimes.neighbors_s (the climb's neighbour generation
(`sample.neighbors`)), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "neighbors_s")
