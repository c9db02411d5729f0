"""Seconds a job waits for its steps' witnesses from the fork pool (the
program's ``supernova_cycle.witness`` timer), over the window's jobs."""


def read(ctx):
    total, count = ctx.hist["supernova_cycle.witness"]
    return total / len(ctx.jobs) if count else None
