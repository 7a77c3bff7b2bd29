"""R1's share of its roofline in the traced window: the summed bound of
its launches (perfbench/roofline/r1.py) over its device time, percent."""


def read(ctx):
    return ctx.roofline_pct("r1")
