"""Span tracing: the port's one record of where the host's time goes,
nested at its layer boundaries.

``span(name, **attrs)`` is a context manager (``instrument`` its
decorator form, the reference's ``#[tracing::instrument]``,
src/proof/nova.rs:260). Every finished span appends one :class:`Record`
to a bounded in-memory log, a ring of :data:`LOG_SIZE` records that
counts what it drops: its name, its ``id``, the enclosing span's id
(``parent``), the id of the outermost span of the request (``trace``:
one prove, one compression, one verification), ``t0`` and ``t1`` from
``time.perf_counter`` (CLOCK_MONOTONIC on Linux, one clock for a
process and the workers it forks), its process and thread, the counts
at that boundary (``attrs``) and, where asked for, the process's CPU
seconds inside it (``cpu_s``). :func:`records` reads the log.

While a ``torch.profiler`` runs in the process, each span is also a
profiler range of its name (``record_function``), so a device trace
places kernels and idle gaps inside the program's spans. A forked
worker's spans never call into torch: the fork pool's workers touch no
torch (``proof/witness_pool.py``); their records travel back with the
results and :func:`merge` adds them to the parent's log.

The span stack is per thread: work handed to another thread keeps its
request's ``trace`` and parent through :func:`carried` (or
:func:`context` and :func:`adopt`).

``LURK_TPU_TRACE=1`` logs each finished outermost span's tree, rendered
from the log, to the ``lurk_tpu_torch.tracing`` logger at INFO (the
reference's tracing-subscriber + TeXRay, src/main.rs:10-16).
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

logger = logging.getLogger("lurk_tpu_torch.tracing")

LOG_SIZE = 1 << 16

_LOG: deque = deque(maxlen=LOG_SIZE)
_LOCK = threading.Lock()
_DROPPED = 0
_IDS = itertools.count(1)
_TLS = threading.local()
_FORKED = False             # a forked child: no torch call
_PID = os.getpid()


def enabled() -> bool:
    """The operator's switch for the logged span trees."""
    return bool(os.environ.get("LURK_TPU_TRACE"))


class Record(NamedTuple):
    """One finished span."""
    name: str
    id: int
    parent: Optional[int]
    trace: int
    t0: float
    t1: float
    pid: int
    tid: int
    attrs: dict
    cpu_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Context(NamedTuple):
    """Where a span would open: its would-be parent and request."""
    id: int
    trace: int


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _append(rec: Record) -> None:
    global _DROPPED
    with _LOCK:
        if len(_LOG) == LOG_SIZE:
            _DROPPED += 1
        _LOG.append(rec)


class span:
    """A span of the log (a context manager). ``cpu=True`` also records
    the process's CPU seconds inside it."""

    __slots__ = ("name", "attrs", "cpu", "id", "parent", "trace", "t0",
                 "t1", "_c0", "_range")

    def __init__(self, name: str, cpu: bool = False, **attrs):
        self.name = name
        self.attrs = attrs
        self.cpu = cpu

    def __enter__(self) -> "span":
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            self.parent, self.trace = stack[-1].id, stack[-1].trace
        else:
            self.parent, self.trace = None, self.id
        stack.append(self)
        self._range = None
        if not _FORKED and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._c0 = time.process_time() if self.cpu else 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        cpu_s = time.process_time() - self._c0 if self.cpu else None
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _append(Record(self.name, self.id, self.parent, self.trace, self.t0,
                       self.t1, _PID, threading.get_ident(),
                       self.attrs, cpu_s))
        if self.parent is None and enabled():
            logger.info("span tree:\n%s", "\n".join(render(self.id)))
        return False


def instrument(name: Optional[str] = None):
    """Decorator form of :class:`span`."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def context() -> Optional[Context]:
    """The calling thread's innermost open span, to hand to another
    thread or process (None outside any span)."""
    stack = _stack()
    return Context(stack[-1].id, stack[-1].trace) if stack else None


class adopt:
    """Spans opened inside take ``ctx`` (from :func:`context`) as their
    parent and request."""

    __slots__ = ("ctx",)

    def __init__(self, ctx: Optional[Context]):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            _stack().append(self.ctx)
        return self

    def __exit__(self, *exc) -> bool:
        if self.ctx is not None:
            _stack().pop()
        return False


def carried(fn: Callable) -> Callable:
    """``fn``, to run in another thread under the caller's span
    context."""
    ctx = context()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with adopt(ctx):
            return fn(*args, **kwargs)

    return run


def records(name: Optional[str] = None, since: Optional[float] = None,
            until: Optional[float] = None) -> List[Record]:
    """The log's records, oldest first: those called ``name`` and
    starting in [since, until], where given."""
    with _LOCK:
        out = list(_LOG)
    return [r for r in out
            if (name is None or r.name == name)
            and (since is None or r.t0 >= since)
            and (until is None or r.t0 <= until)]


def dropped() -> int:
    """Records the ring has dropped, oldest first, since the process
    started."""
    return _DROPPED


def take() -> List[Record]:
    """Remove and return every record (a worker ships its records back
    with its result)."""
    with _LOCK:
        out = list(_LOG)
        _LOG.clear()
    return out


def merge(recs: Iterable[Record]) -> None:
    """Add records from another process: their ids are made anew here,
    links between them kept, links to this process's spans (the
    ``context`` they ran under) left as they are."""
    recs = list(recs)
    ids = {r.id: next(_IDS) for r in recs}
    for r in recs:
        _append(r._replace(id=ids[r.id], parent=ids.get(r.parent, r.parent),
                           trace=ids.get(r.trace, r.trace)))


def render(trace: int) -> List[str]:
    """The tree of one request's records as text: each span's
    milliseconds and share of the outermost."""
    recs = [r for r in records() if r.trace == trace]
    children: Dict[Optional[int], List[Record]] = defaultdict(list)
    for r in recs:
        children[r.parent].append(r)
    roots = [r for r in recs if r.id == trace]
    out: List[str] = []

    def walk(r: Record, depth: int, total: float) -> None:
        pct = 100.0 * r.seconds / total if total else 0.0
        out.append(f"{'  ' * depth}{r.name:<32s} "
                   f"{r.seconds * 1000:10.1f}ms {pct:5.1f}%")
        for c in sorted(children[r.id], key=lambda c: c.t0):
            walk(c, depth + 1, total)

    for root in roots:
        walk(root, 0, root.seconds)
    return out


def _forked() -> None:
    """A forked child starts an empty log and stack of its own and
    never calls into torch."""
    global _FORKED, _PID, _LOG, _LOCK, _DROPPED, _TLS
    _FORKED = True
    _PID = os.getpid()
    _LOG = deque(maxlen=LOG_SIZE)
    _LOCK = threading.Lock()
    _DROPPED = 0
    _TLS = threading.local()


os.register_at_fork(after_in_child=_forked)
