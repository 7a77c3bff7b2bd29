"""Reads mapped in the window over the window's whole time."""


def read(ctx):
    return ctx.work / ctx.window_s if ctx.entry == "map" else None
