"""One run of one cell: set-up, the measured window of whole jobs in a
closed loop of one client, the trace, the metrics, and the reference's
comparison once the window has closed."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import check as ref_check
from . import driver, extract, spans
from .bounds import Bound
from .manifest import Manifest, read_metric
from .trace import WINDOW, TraceSummary

# the reference's processes, after the window: at most one a core
REFERENCE_WORKERS = min(8, os.cpu_count() or 1)

# the program's phase timers that the per-layer metrics read
HISTOGRAMS = [f"supernova_cycle.{n}" for n in (
    "witness", "synthesize_primary", "pack_w1", "cross_term1", "commit_t1",
    "fold_witness1", "synthesize_secondary", "commit_w2", "cross_term2",
    "commit_t2", "fold2")] + ["spartan.kzg_open", "spartan.ipa_open",
                              "ck.table"]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    jobs: List[driver.JobResult]
    steps: int
    hist: Dict[str, tuple]          # name -> (sum, count) in the window
    rec: spans.Recorder
    t0: float
    t1: float
    params_load_s: float
    device: torch.device
    trace: Optional[TraceSummary] = None
    _msm_bound_s: Optional[float] = None

    def span_s(self, name: str) -> float:
        return self.rec.span_seconds(name, self.t0, self.t1)

    def msm_bound_s(self) -> Optional[float]:
        """The least time of the captured K6 launches (the window's first
        job), from their scalars."""
        if self._msm_bound_s is None and self.rec.msm:
            bound = Bound()
            self._msm_bound_s = sum(
                bound.msm(w.view(np.uint32).reshape(-1, 8), rows,
                          self.device)[0]
                for _, w, rows in self.rec.msm) * 1e-3
        return self._msm_bound_s


def run_cell(man: Manifest, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             trace_path: Optional[Path] = None, log=sys.stderr) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    cell = man.cell(cell_name)
    cfg = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    dev = torch.device(device)
    rec = spans.Recorder(trace and dev.type == "cuda")
    spans.install(rec)
    program = driver.Program(cfg, dev, rec)
    stages = mix["stages"]

    with rec.span("bench.params_load"):
        program.public_params()
    params_load_s = rec.spans[-1][2] - rec.spans[-1][1]
    if dev.type == "cuda":
        program.warm_kernels()
    warm = program.run_job(-1, driver.job_inputs(seed, -1, cfg["inputs"],
                                                 mix["input_bits"]),
                           stages, cfg.get("warmup_frames",
                                           cfg["frame_limit"]))
    if warm.failed:
        raise RuntimeError(f"the warm-up job failed: {warm.error}")
    del warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base = {n: len(_values(n)) for n in HISTOGRAMS}

    prof = None
    if rec.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    jobs: List[driver.JobResult] = []
    rec.capture = rec.trace
    with rec.span(WINDOW):
        while True:
            k = len(jobs)
            jobs.append(program.run_job(
                k, driver.job_inputs(seed, k, cfg["inputs"],
                                     mix["input_bits"]),
                stages, cfg["frame_limit"]))
            rec.capture = False
            if time.perf_counter() - t_first >= seconds:
                break
    t0, t1 = jobs[0].t0, jobs[-1].t1
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = trace_path or (man.dir / ".cache" / "trace.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        summary = TraceSummary(path)
        path.unlink()
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    hist = {}
    for n in HISTOGRAMS:
        vals = _values(n)[base[n]:]
        hist[n] = (sum(vals), len(vals))
    ctx = Context(cell, cfg, mix, setup_s, t1 - t0, jobs,
                  sum(j.steps for j in jobs), hist,
                  rec, t0, t1, params_load_s, dev, summary)
    metrics = {}
    for m in man.metrics_of(cell_name, trace):
        v = read_metric(man, m, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        breakdown = {"device_ops": [[n, s] for n, s in
                                    summary.device_ops[:10]],
                     "idle_gaps": [[n, s] for n, s in
                                   summary.idle_by_span[:10]]}

    for j in jobs:
        print(f"job {j.index}: {j.t1 - j.t0:.3f} s"
              + (f", failed: {j.error or 'rejected'}" if j.failed else ""),
              file=log)
    # the reference, once the window has closed and the peak is read
    plain, runs = plain_jobs(jobs)
    p = int(program.field.modulus)
    attempted, failed = len(jobs), sum(j.failed for j in jobs)
    del ctx, jobs, program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = ref_check.check_jobs(plain, runs, cfg["expect"], p,
                                   REFERENCE_WORKERS)
    numbers["failed_off"] = failed
    print(f"reference: {len(plain)} jobs compared in full, in "
          f"{time.perf_counter() - t_ref:.1f} s", file=log)
    return {"attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info, "breakdown": breakdown,
            "numbers": numbers}


def plain_jobs(jobs: List[driver.JobResult]):
    """Every job that ran to its end, as plain data, and the public
    parameters that their proofs name, each once."""
    plain, runs = [], {}
    for j in jobs:
        if j.frames is None or j.error is not None:
            continue
        key = None
        if j.pp is not None:
            key = id(j.pp)
            if key not in runs:
                runs[key] = extract.run_data(j.pp)
        plain.append(extract.job_data(j, key))
    return plain, runs


def _values(name: str) -> list:
    from lurk_tpu_torch.utils import metrics
    return metrics.values(name)
