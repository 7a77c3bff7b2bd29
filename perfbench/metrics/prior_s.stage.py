"""StageTimes.prior_s (genome size, Euler count and prior over the candidates
(`sample.prior`)), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "prior_s")
