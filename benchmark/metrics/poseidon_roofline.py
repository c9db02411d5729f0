"""K1's share of its roofline: the least time of the window's first
job's store waves (``harness.bounds.Bound.of``, at the sparse schedule's
least work), over the device time of the kernels launched inside their
``hash_batch`` ranges (by correlation in the trace)."""

from benchmark.harness.bounds import Bound
from benchmark.reference.poseidon import round_numbers


def read(ctx):
    if ctx.trace is None or not ctx.rec.hash:
        return None
    kernel_s = ctx.trace.kernel_seconds(name for name, _, _ in ctx.rec.hash)
    if kernel_s <= 0:
        return None
    bound = Bound()
    least_ms = sum(bound.of(a + 1, *round_numbers(a + 1), b)[0]
                   for _, a, b in ctx.rec.hash)
    return 100.0 * least_ms * 1e-3 / kernel_s
