"""The window's share in which no operation ran on the device: 1 - the
union of the trace's device operations / the window, percent."""


def read(ctx):
    return ctx.idle_pct()
