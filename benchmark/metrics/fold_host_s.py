"""Host seconds of one folding step outside the witness wait and the
commitments: the program's ``supernova_cycle.*`` timers of synthesis,
packing, cross-terms and folds, over the window's steps."""

PHASES = ("synthesize_primary", "pack_w1", "cross_term1", "fold_witness1",
          "synthesize_secondary", "cross_term2", "fold2")


def read(ctx):
    if not ctx.steps:
        return None
    return sum(ctx.hist[f"supernova_cycle.{p}"][0] for p in PHASES) \
        / ctx.steps
