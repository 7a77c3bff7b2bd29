"""StageTimes.untraced_s (the pass's wall time that no named span of the
program covers), seconds per mapping pass."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "map", "untraced_s")
