"""Seconds a job spends in the secondary's IPA openings on the host (the
program's ``spartan.ipa_open`` timer, in the compression's second
thread), over the window's jobs."""


def read(ctx):
    total, count = ctx.hist["spartan.ipa_open"]
    return total / len(ctx.jobs) if count else None
