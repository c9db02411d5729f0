"""Percent of a forked worker's synthesis time that its process spent
on a core: 100 x the CPU seconds over the wall seconds of the window's
``witness_pool.synthesize`` spans (below 100: the workers and the
parent share the host's cores). None for a program without the span
log."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    synth = records("witness_pool.synthesize", ctx.t0, ctx.t1)
    wall = sum(r.t1 - r.t0 for r in synth)
    if not wall or any(r.cpu_s is None for r in synth):
        return None
    return 100.0 * sum(r.cpu_s for r in synth) / wall
