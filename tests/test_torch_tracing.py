"""The port's span log (``lurk_tpu_torch/utils/tracing.py``) and the
benchmark's readers of it.

- Nesting: ids, parents and the request's ``trace``; ``metrics.timed``
  and ``instrument`` as spans; the ring's bound and its count of drops.
- A span is a profiler range of its name while a profiler runs, and
  opens none otherwise.
- Work handed to a thread keeps the caller's ``trace`` and parent.
- The fork pool: each worker's ``witness_pool.synthesize`` comes back
  into the parent's log with the request's ``trace``, its step and CPU
  seconds, on the parent's clock, and no worker calls into torch.
- Each new reader in ``benchmark/metrics/`` on a synthetic log: the
  window, the set-up, and None without the spans or without the log.
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.proof import witness_pool
from lurk_tpu_torch.r1cs.gadgets import alloc_num
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.utils import metrics, tracing
from lurk_tpu_torch.utils.tracing import Record
from test_torch_field import one_torch_thread  # noqa: F401

METRICS_DIR = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"


def test_spans_nest_into_one_request():
    @tracing.instrument("tracing_test.decorated")
    def decorated():
        with metrics.timed("tracing_test.timed"):
            pass

    t_start = time.perf_counter()
    with tracing.span("tracing_test.outer", rows=3) as outer:
        with tracing.span("tracing_test.inner"):
            decorated()
        assert tracing.context() == (outer.id, outer.id)
    assert tracing.context() is None
    (o,) = tracing.records("tracing_test.outer", t_start)
    (i,) = tracing.records("tracing_test.inner", t_start)
    (d,) = tracing.records("tracing_test.decorated", t_start)
    (t,) = tracing.records("tracing_test.timed", t_start)
    assert (o.parent, o.trace, o.attrs) == (None, o.id, {"rows": 3})
    assert (i.parent, d.parent, t.parent) == (o.id, i.id, d.id)
    assert {r.trace for r in (i, d, t)} == {o.id}
    assert len({o.id, i.id, d.id, t.id}) == 4
    assert o.t0 <= i.t0 <= d.t0 <= t.t0 <= t.t1 <= d.t1 <= i.t1 <= o.t1
    assert {r.pid for r in (o, i, d, t)} == {os.getpid()}
    assert o.cpu_s is None
    assert metrics.values("tracing_test.timed")[-1] == t.seconds
    with tracing.span("tracing_test.next") as nxt:
        pass
    assert nxt.trace == nxt.id != o.id


def test_the_ring_keeps_the_newest_records_and_counts_drops():
    dropped = tracing.dropped()
    for k in range(tracing.LOG_SIZE + 5):
        with tracing.span("tracing_test.ring", k=k):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.LOG_SIZE
    assert tracing.dropped() - dropped >= 5
    assert recs[-1].attrs == {"k": tracing.LOG_SIZE + 4}
    assert recs[0].attrs == {"k": 5}


def test_a_span_is_a_profiler_range_only_under_a_profiler(tmp_path,
                                                          monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("tracing_test.profiled"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    assert any(e.get("name") == "tracing_test.profiled"
               and e.get("cat") == "user_annotation" for e in events)

    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with tracing.span("tracing_test.unprofiled"):
        pass


def test_a_thread_keeps_the_callers_request():
    def secondary():
        with tracing.span("tracing_test.in_thread"):
            return threading.get_ident()

    t_start = time.perf_counter()
    with tracing.span("tracing_test.request") as req:
        with ThreadPoolExecutor(max_workers=1) as ex:
            tid = ex.submit(tracing.carried(secondary)).result()
            ex.submit(secondary).result()
    carried, lone = tracing.records("tracing_test.in_thread", t_start)
    assert (carried.trace, carried.parent, carried.tid) == (req.id, req.id,
                                                            tid)
    assert tid != threading.get_ident()
    assert (lone.trace, lone.parent) == (lone.id, None)


def _toy_step(cs, zi, aux):
    return [alloc_num(cs, (z.value * 3 + aux) % cs.p) for z in zi]


def test_pool_workers_spans_join_the_request(monkeypatch):
    """Each worker's synthesis is a record in the parent's log, from
    another process, under the prove's trace, inside its wait; the
    workers make no torch call (both entries raise in a child)."""
    parent = os.getpid()

    def parent_only(fn):
        def guarded(*args, **kwargs):
            if os.getpid() != parent:
                raise RuntimeError("a forked worker called into torch")
            return fn(*args, **kwargs)
        return guarded

    monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                        parent_only(torch.autograd._profiler_enabled))
    monkeypatch.setattr(torch.profiler, "record_function",
                        parent_only(torch.profiler.record_function))
    store = Store(BN256_SCALAR, device="cpu")
    jobs = [([k, k + 1], k) for k in range(4)]
    t_start = time.perf_counter()
    with tracing.span("tracing_test.prove") as prove:
        out = list(witness_pool.step_witnesses(store, _toy_step, jobs,
                                               False))
    for (seg, outs), (z_in, aux) in zip(out, jobs):
        assert outs == [(z * 3 + aux) for z in z_in] == seg
    (fork,) = tracing.records("witness_pool.fork", t_start)
    synth = {r.attrs["step"]: r
             for r in tracing.records("witness_pool.synthesize", t_start)}
    waits = {r.attrs["step"]: r
             for r in tracing.records("witness_pool.wait", t_start)}
    assert fork.attrs == {"workers": min(4, max(1, os.cpu_count() - 1)),
                          "tasks": 4}
    assert sorted(synth) == sorted(waits) == [0, 1, 2, 3]
    ids = {r.id for r in tracing.records(since=t_start)}
    assert len(ids) == len(tracing.records(since=t_start))
    for k, s in synth.items():
        w = waits[k]
        assert s.pid != parent and w.pid == parent
        assert s.cpu_s is not None and s.cpu_s >= 0
        assert (s.trace, s.parent) == (prove.id, fork.id)
        assert (w.trace, w.parent) == (prove.id, prove.id)
        assert fork.t0 <= s.t0 <= s.t1 <= w.t1 <= prove.t1


def _load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"tracing_test_{metric}", METRICS_DIR / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(name, id, parent, trace, t0, t1, cpu_s=None, **attrs):
    return Record(name, id, parent, trace, t0, t1, 1, 1, attrs, cpu_s)


# Two fib-like proves of two steps in the window [10, 20], one in the
# set-up; a compression and a verification in the window and one before
SYNTHETIC = [
    _rec("params.srs", 90, None, 90, 1.0, 1.5, n=4),
    _rec("params.srs", 91, None, 91, 2.0, 2.25, n=2),
    _rec("witness_pool.fork", 92, None, 92, 5.0, 5.1),
    _rec("witness_pool.synthesize", 93, 92, 92, 5.5, 6.0, 0.5, step=0),
    _rec("witness_pool.wait", 94, 92, 92, 5.1, 6.2, step=0),
    _rec("spartan.ipa_open", 51, None, 51, 6.0, 7.0),
    _rec("ipa.msm", 52, 51, 51, 6.1, 6.5, n=8),
    _rec("spartan.verify.pcs", 53, None, 53, 7.0, 7.5),
    _rec("witness_pool.fork", 2, 1, 1, 10.0, 10.1, workers=2, tasks=2),
    _rec("witness_pool.synthesize", 3, 2, 1, 10.2, 11.2, 0.8, step=0),
    _rec("witness_pool.synthesize", 4, 2, 1, 10.3, 11.5, 0.9, step=1),
    _rec("witness_pool.wait", 5, 1, 1, 10.1, 11.4, step=0),
    _rec("witness_pool.wait", 6, 1, 1, 11.4, 11.6, step=1),
    _rec("params.srs", 95, None, 95, 12.0, 12.5, n=4),
    _rec("witness_pool.fork", 12, 11, 11, 15.0, 15.1, workers=2, tasks=2),
    _rec("witness_pool.synthesize", 13, 12, 11, 15.4, 16.0, 0.3, step=0),
    _rec("witness_pool.synthesize", 14, 12, 11, 15.5, 16.5, 0.5, step=1),
    _rec("witness_pool.wait", 15, 11, 11, 15.1, 16.1, step=0),
    _rec("witness_pool.wait", 16, 11, 11, 16.1, 16.2, step=1),
    _rec("supernova_cycle.compress", 40, None, 40, 17.0, 19.0),
    _rec("spartan.ipa_open", 41, 40, 40, 17.1, 18.0),
    _rec("ipa.pack_gens", 42, 41, 40, 17.1, 17.2, n=8),
    _rec("ipa.msm", 43, 41, 40, 17.2, 17.5, n=8),
    _rec("ipa.msm", 44, 41, 40, 17.5, 17.7, n=8),
    _rec("spartan.verify", 46, None, 46, 19.0, 19.8),
    _rec("spartan.verify.pcs", 47, 46, 46, 19.2, 19.7),
    _rec("ipa.msm", 45, 47, 46, 19.3, 19.6, n=8),
]


@pytest.mark.parametrize("metric, want", [
    ("pool_start_s", (0.2 + 0.4) / 2),
    ("pool_synth_s", (1.0 + 1.2 + 0.6 + 1.0) / 4),
    ("pool_return_s", (0.2 + 0.1 + 0.1 + 0.0) / 4),
    ("pool_cpu_share", 100 * (0.8 + 0.9 + 0.3 + 0.5) / 3.8),
    ("ipa_msm_s", (0.1 + 0.3 + 0.2) / 2),
    ("verify_pcs_s", 0.5 / 2),
    ("params_srs_s", 0.5 + 0.25),
])
def test_readers_of_the_span_log(metric, want, monkeypatch):
    reader = _load_reader(metric)
    ctx = SimpleNamespace(t0=10.0, t1=20.0, jobs=[0, 1], steps=4)
    monkeypatch.setattr(tracing, "_LOG", deque(SYNTHETIC))
    assert reader.read(ctx) == pytest.approx(want)
    monkeypatch.setattr(tracing, "_LOG", deque())
    assert reader.read(ctx) is None
    monkeypatch.delattr(tracing, "records")
    assert reader.read(ctx) is None
