"""Seconds a job spends in ``prove_from_frames`` (the harness's
``bench.prove`` span), over the window's jobs."""


def read(ctx):
    return ctx.span_s("bench.prove") / len(ctx.jobs)
