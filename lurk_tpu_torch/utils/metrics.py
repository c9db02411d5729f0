"""Metrics facade: counters, gauges, histograms with a global sink.

A copy of the JAX package's ``utils/metrics.py``, plus :func:`values`
(a histogram's samples in order: the prover records each step's phase
times here, ``nova.*``, which ``chip_smoke.py`` prints per step).

Parity: the reference's `lurk-metrics` crate (lurk-metrics/src/lib.rs:
22-100, data.rs:11-168) — thread-local sinks drained periodically by a
publisher thread into a global aggregator that logs to
`lurk_tpu_torch.metrics`. Python threads share one lock-guarded sink; the
5-second drain cadence matches the reference.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

logger = logging.getLogger("lurk_tpu_torch.metrics")

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = defaultdict(int)
_GAUGES: Dict[str, float] = {}
_HISTOGRAMS: Dict[str, List[float]] = defaultdict(list)
_PUBLISHER: threading.Thread = None  # type: ignore[assignment]
_STOP = threading.Event()
DRAIN_INTERVAL_SECS = 5.0


def counter(name: str, value: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] += value


def gauge(name: str, value: float) -> None:
    with _LOCK:
        _GAUGES[name] = value


def histogram(name: str, value: float) -> None:
    with _LOCK:
        _HISTOGRAMS[name].append(value)


def values(name: str) -> List[float]:
    """The samples of one histogram, in the order they were recorded."""
    with _LOCK:
        return list(_HISTOGRAMS.get(name, ()))


def snapshot() -> Tuple[Dict[str, int], Dict[str, float],
                        Dict[str, dict]]:
    """Aggregated view; histograms summarized (count/sum/min/max/avg)."""
    with _LOCK:
        counters = dict(_COUNTERS)
        gauges = dict(_GAUGES)
        hists = {}
        for name, vals in _HISTOGRAMS.items():
            if vals:
                hists[name] = {
                    "count": len(vals),
                    "sum": sum(vals),
                    "min": min(vals),
                    "max": max(vals),
                    "avg": sum(vals) / len(vals),
                }
    return counters, gauges, hists


def drain() -> None:
    """Log and reset the sink (publisher thread body)."""
    counters, gauges, hists = snapshot()
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()
    for name, v in counters.items():
        logger.info("counter %s: %d", name, v)
    for name, v in gauges.items():
        logger.info("gauge %s: %g", name, v)
    for name, h in hists.items():
        logger.info("histogram %s: n=%d avg=%g min=%g max=%g",
                    name, h["count"], h["avg"], h["min"], h["max"])


def install() -> None:
    """Start the periodic publisher (main.rs metrics sink parity)."""
    global _PUBLISHER
    if _PUBLISHER is not None:
        return

    def run():
        while not _STOP.wait(DRAIN_INTERVAL_SECS):
            drain()

    _PUBLISHER = threading.Thread(target=run, name="lurk-metrics",
                                  daemon=True)
    _PUBLISHER.start()


class timed:
    """Context manager recording elapsed seconds into a histogram."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        histogram(self.name, time.perf_counter() - self.t0)
        return False
