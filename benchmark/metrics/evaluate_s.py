"""Seconds a job spends reading, evaluating and hydrating its program
(the harness's ``bench.evaluate`` span), over the window's jobs."""


def read(ctx):
    return ctx.span_s("bench.evaluate") / len(ctx.jobs)
