"""StageTimes.refine_s (hint-restricted decodes: R1, then R2, with the host
copies), seconds per k-stage."""


def read(ctx):
    return ctx.per_stage("refine_s") if ctx.entry == "infer" else None
