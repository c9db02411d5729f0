"""The benchmark of ``lurk_tpu_torch`` on one H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix
and metrics are found by name through ``BENCHMARK.json``
(``benchmark/harness/manifest.py``). Set-up loads the port and its
public parameters (built into ``benchmark/.cache/`` on the first run of
a checkout), builds the keys' tables on the card and runs one warm-up
job; then whole jobs run back to back for ``--seconds`` (the job in
flight finishes). ``--trace 1`` profiles the window and reports the
per-layer metrics; ``--trace 0`` the end-to-end ones. Once the window
has closed the plain reference (``benchmark/reference``) judges the
jobs' outputs. The last line of standard output is the result's JSON;
the numbers compared, each beside its limit, are also the last lines of
standard error. Exits 1 without a card, and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lurk_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``lurk_tpu_torch`` is not ``lurk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env, hostinfo
    from benchmark.harness.manifest import Manifest
    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    env.prepare(man.dir)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 1
    import lurk_tpu_torch  # noqa: F401  (fails in a bare checkout)
    print(hostinfo.line("before"), flush=True)

    from benchmark.harness.cell import run_cell
    out = run_cell(man, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    print(hostinfo.line("after"), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1

    from benchmark.reference.check import LIMITS, correct
    numbers = out["numbers"]
    ok = correct(numbers) and out["failed"] == 0
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in
              numbers.items()}
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": out["device"]}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
