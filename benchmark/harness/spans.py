"""Host spans and the wrappers the harness puts around the program's
layer boundaries.

Every span is a host-clock interval (``time.perf_counter``) with its
name and thread; in a traced run it is also a profiler range
(``torch.profiler.record_function``), so the trace places kernels and
idle gaps inside it. The program's own phase timers
(``lurk_tpu_torch.utils.metrics.timed``: ``supernova_cycle.*``,
``spartan.*``, ``ck.table``) become spans by wrapping that class; the
K6 launches (``msm.kernel.MsmTable.msm_words_async``: the scalars'
copy to the card and ``msm_words``) and the store's K1 waves
(``store.core.hash_batch``) each get a range of their own, numbered, so
that the trace attributes each launch's kernels by correlation.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Tuple

import numpy as np
import torch

MSM_RANGE = "bench.msm_words"
HASH_RANGE = "bench.hash_batch"


class Recorder:
    def __init__(self, trace: bool):
        self.trace = trace
        self.pid = os.getpid()
        self.spans: List[Tuple[str, float, float, int]] = []
        # (range name, scalar words copied on the host, table rows) of
        # each K6 launch while ``capture`` is on (the traced window's
        # first job)
        self.msm: List[Tuple[str, np.ndarray, int]] = []
        # (range name, arity, hashes) of each K1 wave while capturing
        self.hash: List[Tuple[str, int, int]] = []
        self.capture = False
        self._lock = threading.Lock()
        self._n = 0

    def _range(self, name: str):
        if self.trace and os.getpid() == self.pid:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def span(self, name: str):
        if os.getpid() != self.pid:       # a forked worker of the program
            yield
            return
        t0 = time.perf_counter()
        try:
            with self._range(name):
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((name, t0, t1, threading.get_ident()))

    def numbered(self, base: str) -> str:
        with self._lock:
            self._n += 1
            return f"{base}#{self._n}"

    def span_seconds(self, name: str, t0: float, t1: float) -> float:
        """Seconds of the spans called ``name`` that start in [t0, t1]."""
        return sum(e - s for n, s, e, _ in self.spans
                   if n == name and t0 <= s <= t1)


def install(rec: Recorder) -> None:
    """Wrap the program's phase timers, its K6 entry and its K1 waves."""
    from lurk_tpu_torch.msm import kernel as msm_kernel
    from lurk_tpu_torch.store import core as store_core
    from lurk_tpu_torch.utils import metrics

    base_timed = metrics.timed

    class timed(base_timed):
        """The program's timer, also a harness span."""

        def __enter__(self):
            self._span = rec.span(self.name)
            self._span.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            self._span.__exit__(*exc)
            return out

    metrics.timed = timed

    msm_words_async = msm_kernel.MsmTable.msm_words_async

    def bench_msm_words(table, words):
        """K6's entry: the scalars' copy to the card and the launch."""
        name = rec.numbered(MSM_RANGE) if rec.capture else MSM_RANGE
        if rec.capture:
            rec.msm.append((name, words.cpu().numpy().copy(),
                            min(words.shape[0], table.n_points)))
        with rec._range(name):
            return msm_words_async(table, words)

    msm_kernel.MsmTable.msm_words_async = bench_msm_words

    hash_batch = store_core.hash_batch

    def bench_hash_batch(field, arity, pres, device=None):
        name = rec.numbered(HASH_RANGE) if rec.capture else HASH_RANGE
        with rec._range(name):
            out = hash_batch(field, arity, pres, device=device)
        if rec.capture:
            rec.hash.append((name, arity, len(pres)))
        return out

    store_core.hash_batch = bench_hash_batch
