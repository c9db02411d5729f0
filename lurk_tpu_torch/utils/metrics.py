"""The port's phase timers: histograms of host-clock seconds by name.

:class:`timed` is a span of :mod:`.tracing` that also records its
seconds into the histogram of its name; :func:`values` returns a
histogram's samples in order (the provers record each step's phase
times, ``nova.*``, ``supernova_cycle.*``, ``spartan.*``, which
``chip_smoke.py`` prints per step and the benchmark reads), and
:func:`drain` empties them all.

Parity: the histograms of the reference's `lurk-metrics` crate
(lurk-metrics/src/lib.rs:22-100, data.rs:11-168). Python threads share
one lock-guarded sink.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List

from . import tracing

_LOCK = threading.Lock()
_HISTOGRAMS: Dict[str, List[float]] = defaultdict(list)


def histogram(name: str, value: float) -> None:
    with _LOCK:
        _HISTOGRAMS[name].append(value)


def values(name: str) -> List[float]:
    """The samples of one histogram, in the order they were recorded."""
    with _LOCK:
        return list(_HISTOGRAMS.get(name, ()))


def drain() -> None:
    """Empty every histogram."""
    with _LOCK:
        _HISTOGRAMS.clear()


class timed:
    """Context manager: a span called ``name`` whose seconds also go to
    the histogram ``name``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._trace_span = tracing.span(self.name).__enter__()
        return self

    def __exit__(self, *exc):
        s = self._trace_span
        s.__exit__(*exc)
        histogram(self.name, s.t1 - s.t0)
        return False
