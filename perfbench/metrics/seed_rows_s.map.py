"""StageTimes.seed_rows_s (the seeded rows: unpacking, backfill and stacking
into [L, W], summed over reads), seconds per mapping pass."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "map", "seed_rows_s")
