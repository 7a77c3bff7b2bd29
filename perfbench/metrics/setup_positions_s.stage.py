"""StageTimes.setup_positions_s (`setup.positions`: the read and mapping
pads, the node frequencies and `precompute_positions`), seconds per
k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "setup_positions_s")
