"""StageTimes.seed_chain_s (the chain DP (native or Python), summed over
reads), seconds per mapping pass."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "map", "seed_chain_s")
