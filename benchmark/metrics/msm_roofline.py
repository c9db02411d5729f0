"""K6's share of its roofline: the least time of the window's first
job's commits on the card (``harness.bounds.Bound.msm``, from their
scalars), over the device time of the kernels launched inside their
``msm_words`` ranges (by correlation in the trace)."""


def read(ctx):
    if ctx.trace is None or not ctx.rec.msm:
        return None
    kernel_s = ctx.trace.kernel_seconds(name for name, _, _ in ctx.rec.msm)
    if kernel_s <= 0:
        return None
    return 100.0 * ctx.msm_bound_s() / kernel_s
