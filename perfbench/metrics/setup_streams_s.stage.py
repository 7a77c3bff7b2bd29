"""StageTimes.setup_streams_s (`setup.streams`: the scorer's streams and
the wait for the device), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "setup_streams_s")
