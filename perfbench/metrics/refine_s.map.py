"""StageTimes.refine_s (R1, then R2, over the seeded sets, with the host
copies), seconds per mapping pass."""


def read(ctx):
    return ctx.per_stage("refine_s") if ctx.entry == "map" else None
