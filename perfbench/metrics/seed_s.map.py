"""StageTimes.seed_s (exact k-mer seeding on the host), seconds per mapping
pass."""


def read(ctx):
    return ctx.per_stage("seed_s") if ctx.entry == "map" else None
