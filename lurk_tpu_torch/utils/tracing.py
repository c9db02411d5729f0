"""Span tracing: nested wall-clock instrumentation for the prover hot
paths, rendered as a TeXRay-style tree.

Parity target: the reference installs tracing-subscriber + TeXRay in
main (src/main.rs:10-16) and instruments the prove loops
(src/proof/nova.rs:260 `#[tracing::instrument(...)]`). Here: `span()`
is a context manager / decorator; finished top-level spans log a
duration tree to the `lurk_tpu_torch.tracing` logger. Enable with
LURK_TPU_TRACE=1 (logging at INFO) — zero overhead when disabled.
For device-side profiling use torch.profiler around the same spans
(`with span("x"), torch.profiler.profile(): ...`).
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

logger = logging.getLogger("lurk_tpu_torch.tracing")

_TLS = threading.local()


def enabled() -> bool:
    return bool(os.environ.get("LURK_TPU_TRACE"))


class _Span:
    __slots__ = ("name", "t0", "dt", "children")

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.dt = 0.0
        self.children: List[_Span] = []

    def render(self, total: Optional[float] = None, depth: int = 0,
               out: Optional[List[str]] = None) -> List[str]:
        out = out if out is not None else []
        total = total if total is not None else self.dt
        pct = 100.0 * self.dt / total if total else 0.0
        out.append(f"{'  ' * depth}{self.name:<32s} "
                   f"{self.dt * 1000:10.1f}ms {pct:5.1f}%")
        for c in self.children:
            c.render(total, depth + 1, out)
        return out


@contextmanager
def span(name: str):
    if not enabled():
        yield None
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    s = _Span(name)
    if stack:
        stack[-1].children.append(s)
    stack.append(s)
    try:
        yield s
    finally:
        s.dt = time.perf_counter() - s.t0
        stack.pop()
        if not stack:
            logger.info("span tree:\n%s", "\n".join(s.render()))


def instrument(name: Optional[str] = None):
    """Decorator form (the reference's #[tracing::instrument])."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco
