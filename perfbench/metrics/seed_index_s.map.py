"""StageTimes.seed_index_s (the seed index build (`seed.index`)), seconds per
mapping pass."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "map", "seed_index_s")
