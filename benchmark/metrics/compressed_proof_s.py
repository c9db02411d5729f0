"""Seconds per shipped proof (evaluate, prove, compress, verify): the
window over its jobs."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs)
