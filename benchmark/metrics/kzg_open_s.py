"""Seconds a job spends in the primary's HyperKZG openings (the
program's ``spartan.kzg_open`` timer), over the window's jobs."""


def read(ctx):
    total, count = ctx.hist["spartan.kzg_open"]
    return total / len(ctx.jobs) if count else None
