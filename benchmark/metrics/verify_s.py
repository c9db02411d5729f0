"""Seconds a job spends in the compressed proof's verifier (the
harness's ``bench.verify`` span), over the window's jobs."""


def read(ctx):
    return ctx.span_s("bench.verify") / len(ctx.jobs)
