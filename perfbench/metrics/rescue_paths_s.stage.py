"""StageTimes.neighbors_paths_s (its timer: each zero edge's k
shortest simple paths in the residual graphs; in the final pass the long
neighbours' min-weight cycles too), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "neighbors_paths_s")
