"""StageTimes.decode_s (from-scratch decodes: A1, then R2, with the host
copies), seconds per k-stage."""


def read(ctx):
    return ctx.per_stage("decode_s") if ctx.entry == "infer" else None
