"""What the per-layer metrics of the program's own spans read: the
``StageTimes`` dicts a traced run collects (``Context.stage_times``, one
per k-stage or mapping pass).  A program whose ``StageTimes`` lacks a
field gives nothing, so that the metric is left out of its result line."""

from __future__ import annotations


def has(ctx, entry: str, *fields: str) -> bool:
    return (ctx.entry == entry and bool(ctx.stage_times)
            and all(f in ctx.stage_times[0] for f in fields))


def per_pass(ctx, entry: str, *fields: str):
    """The sum of ``fields``, averaged over the run's stages or passes."""
    if not has(ctx, entry, *fields):
        return None
    return sum(ctx.per_stage(f) for f in fields)


def kept_pct(ctx, entry: str):
    """100 x the mapping bytes the program keeps / those it copied to the
    host, over the whole run."""
    if not has(ctx, entry, "kept_bytes", "fetch_bytes"):
        return None
    fetched = sum(st["fetch_bytes"] for st in ctx.stage_times)
    if fetched <= 0:
        return None
    return 100.0 * sum(st["kept_bytes"] for st in ctx.stage_times) / fetched
