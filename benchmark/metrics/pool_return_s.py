"""Seconds the prove waits for a step's witness after its worker has
finished it (the result's pickle, the pipe and ``unpack_segment``): for
each ``witness_pool.wait``, its end less the later of its start and the
end of its step's ``witness_pool.synthesize``, at least 0, over the
window's steps. None for a program without the span log."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    waits = records("witness_pool.wait", ctx.t0, ctx.t1)
    synth = {(r.trace, r.attrs.get("step")): r
             for r in records("witness_pool.synthesize")}
    keys = [(w.trace, w.attrs.get("step")) for w in waits]
    if not waits or not ctx.steps or any(k not in synth for k in keys):
        return None
    return sum(max(0.0, w.t1 - max(w.t0, synth[k].t1))
               for w, k in zip(waits, keys)) / ctx.steps
