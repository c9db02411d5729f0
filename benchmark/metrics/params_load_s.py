"""Seconds of set-up spent on the public parameters: the shapes and the
SRS and generators from the disk cache (built there on a checkout's
first run), and both keys' tables on the card (the harness's
``bench.params_load`` span)."""


def read(ctx):
    return ctx.params_load_s
