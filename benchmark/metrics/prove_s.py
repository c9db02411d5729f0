"""Seconds per evaluated and proved job: the window over its jobs."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs)
