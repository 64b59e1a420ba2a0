"""Seconds from the process's start to the window's opening."""


def read(ctx):
    return ctx.setup_s
