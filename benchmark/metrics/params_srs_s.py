"""Seconds of set-up spent loading the commitment keys' SRS and
generators from the disk cache (the program's ``params.srs`` spans that
end before the window; the rest of ``params_load_s`` is the shapes and
the tables). None for a program without the span log."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    srs = [r for r in records("params.srs") if r.t1 < ctx.t0]
    if not srs:
        return None
    return sum(r.t1 - r.t0 for r in srs)
