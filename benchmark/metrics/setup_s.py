"""Seconds from the process's start to the first timed job: imports,
the public parameters, the keys' tables, the kernels, the warm-up."""


def read(ctx):
    return ctx.setup_s
