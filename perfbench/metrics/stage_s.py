"""The window's whole time over the k-stages completed in it."""


def read(ctx):
    return ctx.window_s / ctx.work if ctx.entry == "infer" else None
