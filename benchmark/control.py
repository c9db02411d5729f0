"""The control and the planted faults of a cell, read by the reference
at the cell's own size: for each seed, one sound job and one job under
each fault, in one process (set-up once), each judged as a run's jobs
are, the seed's jobs side by side in ``--workers`` processes. The
benchmark's runs never do this.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        [--faults control,step_unchanged,...] [--device cuda] [--workers 8]

Prints one JSON line per job: the seed, the fault (``sound`` for none),
whether the job raised, and the reference's numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def judge(man, cell_name: str, seeds, faults, device: str, out=sys.stdout,
          workers: int = 1):
    import torch
    from benchmark.harness import cell, driver, spans
    from benchmark.harness.faults import planted
    from benchmark.reference import check
    entry = man.cell(cell_name)
    cfg = man.config(entry["config"])
    mix = man.traffic(entry["traffic"])
    rec = spans.Recorder(False)
    program = driver.Program(cfg, torch.device(device), rec)
    program.public_params()
    p = int(program.field.modulus)
    rows = []
    for seed in seeds:
        inputs = driver.job_inputs(seed, 0, cfg["inputs"],
                                   mix["input_bits"])
        done, plain, runs = [], [], {}
        for fault in ["sound", *faults]:
            t0 = time.perf_counter()
            with planted(fault) if fault != "sound" else nullcontext():
                job = program.run_job(0, inputs, mix["stages"],
                                      cfg["frame_limit"])
            row = {"seed": seed, "fault": fault, "error": job.error,
                   "job_s": time.perf_counter() - t0,
                   "numbers": {"failed_off": int(job.failed)}}
            some, used = cell.plain_jobs([job])
            runs.update(used)
            done.append((row, len(plain), len(some)))
            plain += some
            del job
        each = check.check_each(plain, runs, cfg["expect"], p, workers)
        for row, at, n in done:
            for numbers in each[at:at + n]:
                row["numbers"].update(numbers)
            row["correct"] = check.correct(row["numbers"])
            print(json.dumps(row), file=out, flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="control")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=1,
                    help="the reference's processes")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env
    from benchmark.harness.manifest import Manifest
    man = Manifest(ROOT)
    env.prepare(man.dir)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    judge(man, args.workload, [int(s) for s in args.seeds.split(",")],
          [f for f in args.faults.split(",") if f], args.device,
          workers=args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
