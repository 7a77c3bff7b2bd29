"""StageTimes.map_fetch_s (the mapping's copy to the host, waiting for the
device included (`map.fetch`)), seconds per k-stage."""

from perfbench.stage_split import per_pass


def read(ctx):
    return per_pass(ctx, "infer", "map_fetch_s")
