"""Seconds one folding step waits on its commitments (the program's
``supernova_cycle.{commit_t1, commit_w2, commit_t2}`` timers; W1's
commit is dispatched ahead and overlaps the cross-term), over the
window's steps."""

PHASES = ("commit_t1", "commit_w2", "commit_t2")


def read(ctx):
    if not ctx.steps:
        return None
    return sum(ctx.hist[f"supernova_cycle.{p}"][0] for p in PHASES) \
        / ctx.steps
