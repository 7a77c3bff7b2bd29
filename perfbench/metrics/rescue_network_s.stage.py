"""StageTimes.neighbors_network_s (`neighbors.network`: the climb graph's copy
numbers, the MSE networks and their residual graphs, the per-edge costs;
in the final pass the +-1 band networks too), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "neighbors_network_s")
