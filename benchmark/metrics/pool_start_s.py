"""Seconds from the fork pool's start to its first synthesis in a job:
step 0's ``witness_pool.synthesize`` start less its prove's
``witness_pool.fork`` start (forking the workers, a worker's start and
the first job's trip to it), over the window's jobs. The program's span
log; None for a program without one."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    forks = records("witness_pool.fork", ctx.t0, ctx.t1)
    first = {r.parent: r for r in records("witness_pool.synthesize")
             if r.attrs.get("step") == 0}
    if not forks or any(f.id not in first for f in forks):
        return None
    return sum(first[f.id].t0 - f.t0 for f in forks) / len(ctx.jobs)
