"""Throughput table across rc values on the port: the reference's
examples/tp_table.rs:40-147 (the port of the JAX package's
``examples/tp_table.py``). For each rc and fold count, fib is evaluated
for ``(folds + 1) * rc`` frames and proved by ``NovaProver``, ``reps``
times; it prints the raw frames/s (frames over the prove's seconds) and
the adjusted frames/s (the first, mandatory step's rc frames left out),
each as mean±stdev.

Usage: ``python3 scripts/torch_tp_table.py [--rcs 10,20] [--folds 1,2]
[--reps 2] [--field bn256] [--device cuda|cpu]`` from the root of the
repo (without a card and without ``--device cpu`` it exits 1). The
prove's seconds are host clock, after a synchronize on the card; the
first prove of each rc includes its public parameters (built, or loaded
from ``$LURK_TPU_CACHE``), as in the JAX script.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.examples import FIB_PROGRAM  # noqa: E402
from lurk_tpu_torch.fields import FIELDS  # noqa: E402
from lurk_tpu_torch.lem import evaluation as ev  # noqa: E402
from lurk_tpu_torch.parser import read_with_default_state  # noqa: E402
from lurk_tpu_torch.proof.prover import NovaProver  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402


def n_iters(n_folds: int, rc: int) -> int:
    return (n_folds + 1) * rc


def _mean_sd(xs) -> str:
    sd = statistics.stdev(xs) if len(xs) > 1 else 0.0
    return f"{statistics.mean(xs):.2f}±{sd:.2f}"


def tp_table(rcs, folds, reps: int, field: str, device):
    """``(raw rows, adjusted rows)``: a row an rc, ``[rc, mean±sd for
    each fold count]``, from ``reps`` proves each."""
    dev = resolve_device(device)
    rows_raw, rows_adj = [], []
    for rc in rcs:
        raw_line, adj_line = [str(rc)], [str(rc)]
        for nf in folds:
            tps, tps_adj = [], []
            for _ in range(reps):
                store = Store(FIELDS[field], dev)
                expr = read_with_default_state(store, FIB_PROGRAM)
                frames = ev.evaluate(None, expr, store, n_iters(nf, rc))
                prover = NovaProver(rc=rc, device=dev)
                t0 = time.perf_counter()
                prover.prove_from_frames(store, frames)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                tps.append(len(frames) / dt)
                tps_adj.append(max(len(frames) - rc, 1) / dt)
            raw_line.append(_mean_sd(tps))
            adj_line.append(_mean_sd(tps_adj))
        rows_raw.append(raw_line)
        rows_adj.append(adj_line)
    return rows_raw, rows_adj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rcs", default="10,20")
    ap.add_argument("--folds", default="1,2")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--field", default="bn256")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    rcs = [int(v) for v in args.rcs.split(",")]
    folds = [int(v) for v in args.folds.split(",")]
    rows_raw, rows_adj = tp_table(rcs, folds, args.reps, args.field,
                                  args.device)
    header = ["rc\\folds"] + [str(nf) for nf in folds]
    for title, rows in (("raw frames/s", rows_raw),
                        ("adjusted frames/s", rows_adj)):
        print(f"\n== {title} ==")
        print("  ".join(f"{h:>12}" for h in header))
        for row in rows:
            print("  ".join(f"{v:>12}" for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
