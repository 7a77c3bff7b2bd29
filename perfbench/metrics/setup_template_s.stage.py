"""StageTimes.setup_template_s (`setup.template`: the PHMM template of the
stage's graph), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "setup_template_s")
