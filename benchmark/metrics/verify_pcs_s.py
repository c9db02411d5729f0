"""Seconds a job's compressed verifier spends in its commitment openings'
checks (the program's ``spartan.verify.pcs`` spans: HyperKZG's pairing
check, the IPA's, the SRS's load), over the window's jobs. None for a
program without the span log."""


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    pcs = records("spartan.verify.pcs", ctx.t0, ctx.t1)
    if not pcs:
        return None
    return sum(r.t1 - r.t0 for r in pcs) / len(ctx.jobs)
