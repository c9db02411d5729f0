"""The profiler's trace of the window, reduced to what the metrics read:
the device's busy time, its operations by name, its idle gaps by the
host span they fall in, and the kernel time launched inside each
numbered harness range (a kernel belongs to the range in which the host
thread launched it: the launch call and the kernel share a correlation
id in the trace)."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "bench.window"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class TraceSummary:
    def __init__(self, path: Path, range_prefixes=("bench.msm_words#",
                                                   "bench.hash_batch#")):
        events = json.loads(Path(path).read_text())
        events = events.get("traceEvents", events)
        xs = [e for e in events if e.get("ph") == "X"]
        ann = [e for e in xs if e.get("cat") == "user_annotation"]
        win = [e for e in ann if e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("no window range in the trace")
        w = win[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        clipped = [(max(float(e["ts"]), self.w0),
                    min(float(e["ts"]) + float(e["dur"]), self.w1))
                   for e in dev]
        busy = _union([(s, e) for s, e in clipped if e > s])
        self.window_s = (self.w1 - self.w0) * 1e-6
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.device_events = len(dev)
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[e.get("name", "?")] += float(e["dur"]) * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])

        # idle gaps inside the window, by the innermost host span of the
        # main thread that holds the gap's middle
        gaps, t = [], self.w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.w1:
            gaps.append((t, self.w1))
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in ann
                       if e.get("tid") == self.main_tid
                       and e["name"] != WINDOW
                       and not e["name"].startswith(range_prefixes))
        starts = [s for s, _, _ in spans]
        idle: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label = "outside any span"
            # the latest-starting span that holds the middle is innermost
            for s, e, name in reversed(spans[:bisect.bisect_right(starts,
                                                                  mid)]):
                if e >= mid:
                    label = name
                    break
            idle[label] += (g1 - g0) * 1e-6
        self.idle_by_span = sorted(idle.items(), key=lambda kv: -kv[1])

        # kernel time by numbered range, through the launch's correlation
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("tid"), e["name"]) for e in ann
                  if e["name"].startswith(range_prefixes)]
        launches = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (float(e["ts"]), e.get("tid"))
        self.range_kernel_s: Dict[str, float] = defaultdict(float)
        for e in dev:
            if e.get("cat") != "kernel":
                continue
            corr = (e.get("args") or {}).get("correlation")
            at = launches.get(corr)
            if at is None:
                continue
            for s, end, tid, name in ranges:
                if tid == at[1] and s <= at[0] <= end:
                    self.range_kernel_s[name] += float(e["dur"]) * 1e-6
                    break

    def kernel_seconds(self, names) -> float:
        return sum(self.range_kernel_s.get(n, 0.0) for n in names)
