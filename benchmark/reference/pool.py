"""Run the reference's independent pieces in worker processes.

Workers are spawned, not forked: the process that ran the program has
threads, and a fork copies their locks in whatever state they are. A
worker imports the reference afresh, gets what all its items share once
through ``init(*init_args)``, and then one item at a time; everything
crosses a pipe pickled, so ``fn`` and ``init`` are module-level
functions. Workers touch neither the program nor the device."""

from __future__ import annotations

import multiprocessing
from typing import Callable, List, Optional, Sequence


def run(fn: Callable, items: Sequence, workers: int,
        init: Optional[Callable] = None, init_args: tuple = ()) -> List:
    """``[fn(x) for x in items]`` after ``init(*init_args)``, in up to
    ``workers`` processes (in this one where that is one)."""
    workers = min(workers, len(items))
    if workers <= 1:
        if init is not None:
            init(*init_args)
        return [fn(x) for x in items]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=init, initargs=init_args) as pool:
        return pool.map(fn, items, chunksize=1)
