"""StageTimes.untraced_s (the stage's wall time that no named span of the
program covers), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "untraced_s")
