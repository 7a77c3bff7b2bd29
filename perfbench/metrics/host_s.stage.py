"""StageTimes.host_s (the k-stage's wall time less its seed, decode, refine,
scorer set-up and score times: the climb, purge and extend, the MSE re-init,
host copies), seconds per k-stage."""


def read(ctx):
    return ctx.per_stage("host_s") if ctx.entry == "infer" else None
