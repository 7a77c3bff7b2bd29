"""StageTimes.kept_bytes / fetch_bytes over the run's mapping passes: the
share of the mapping bytes copied to the host that the mappings keep,
percent."""

from perfbench.stage_split import kept_pct


def read(ctx):
    return kept_pct(ctx, "map")
