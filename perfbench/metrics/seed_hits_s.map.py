"""StageTimes.seed_hits_s (the per-position suffix lookups, summed over
reads), seconds per mapping pass."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "map", "seed_hits_s")
