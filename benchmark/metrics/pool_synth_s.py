"""Seconds a forked worker spends synthesizing one step's witness (the
program's ``witness_pool.synthesize`` spans, recorded in the workers),
over the window's steps. None for a program without the span log."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    synth = records("witness_pool.synthesize", ctx.t0, ctx.t1)
    if not synth or not ctx.steps:
        return None
    return sum(r.t1 - r.t0 for r in synth) / ctx.steps
