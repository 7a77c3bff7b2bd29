"""StageTimes.setup_s (template, slot positions, scorer streams), seconds per
k-stage."""


def read(ctx):
    return ctx.per_stage("setup_s") if ctx.entry == "infer" else None
