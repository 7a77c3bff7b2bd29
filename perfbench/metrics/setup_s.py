"""Set-up: process start to the window's start (imports, CUDA, the
program's libraries, the inputs, one warm unit)."""


def read(ctx):
    return ctx.setup_s
