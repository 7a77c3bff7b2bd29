"""StageTimes.extend_s (purge and extension to k+1 (`purge_extend`)), seconds
per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "extend_s")
