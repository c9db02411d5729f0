"""Seconds a job's IPA openings spend in their MSMs on the host: the
program's ``ipa.pack_gens`` and ``ipa.msm`` spans under a
``spartan.ipa_open`` span (the rest of ``ipa_open_s`` is the rounds'
Python loops), over the window's jobs. None for a program without the
span log."""

MSM_SPANS = ("ipa.pack_gens", "ipa.msm")


def read(ctx):
    try:
        from lurk_tpu_torch.utils.tracing import records
    except ImportError:
        return None
    recs = records()
    by_id = {r.id: r for r in recs}

    def opening(r):
        p = by_id.get(r.parent)
        while p is not None and p.name != "spartan.ipa_open":
            p = by_id.get(p.parent)
        return p is not None

    msm = [r for r in recs if r.name in MSM_SPANS
           and ctx.t0 <= r.t0 <= ctx.t1 and opening(r)]
    if not msm:
        return None
    return sum(r.t1 - r.t0 for r in msm) / len(ctx.jobs)
