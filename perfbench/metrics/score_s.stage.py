"""StageTimes.score_s (the candidates' read likelihoods, K1), seconds per
k-stage."""


def read(ctx):
    return ctx.per_stage("score_s") if ctx.entry == "infer" else None
