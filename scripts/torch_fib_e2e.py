"""fib(n) at rc on the port's default backend, end to end: evaluate,
then ``SuperNovaCycleProver`` prove + ``compress_sn_cycle`` +
``verify_compressed_sn_cycle``, each in a span (the reference's
benches/fibonacci.rs; the port of the JAX package's
``scripts/fib_e2e.py``).

Usage: ``python3 scripts/torch_fib_e2e.py [n] [rc] [--device cuda|cpu]``
from the root of the repo (defaults 100 100 cuda; without a card and
without ``--device cpu`` it exits 1). The first run in a
``$LURK_TPU_CACHE`` builds the public parameters into it (the prove's
time includes that); a second run loads them, the warm number. The span
tree goes to the log (``LURK_TPU_TRACE``, on unless set); the last line
is the prove + compress + verify seconds (host clock, after a
synchronize) and frames per second.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit  # noqa: E402
from lurk_tpu_torch.fields import BN256_SCALAR  # noqa: E402
from lurk_tpu_torch.lem import evaluation as ev  # noqa: E402
from lurk_tpu_torch.lem.evaluation import Lang  # noqa: E402
from lurk_tpu_torch.parser import read_with_default_state  # noqa: E402
from lurk_tpu_torch.proof import prover_supernova_cycle as psc  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402
from lurk_tpu_torch.utils.tracing import span  # noqa: E402


def fib_e2e(n: int, rc: int, device) -> dict:
    """Evaluate fib(n) and prove, compress and verify it at ``rc`` on
    ``device``; returns the frames and each part's seconds. Raises if
    the compressed proof does not verify."""
    dev = resolve_device(device)

    def timed(name, fn):
        t0 = time.perf_counter()
        with span(f"fib.{name}"):
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    times = {}
    store = Store(BN256_SCALAR, dev)
    expr = read_with_default_state(store, FIB_PROGRAM)
    frames = timed("evaluate", lambda: ev.evaluate(
        None, expr, store, fib_limit(n, rc)))
    prover = psc.SuperNovaCycleProver(rc=rc, lang=Lang(), device=dev)
    pp, proof = timed("prove", lambda: prover.prove_from_frames(store,
                                                                frames))
    cp = timed("compress", lambda: psc.compress_sn_cycle(pp, proof))
    if not timed("verify", lambda: psc.verify_compressed_sn_cycle(pp, cp)):
        raise RuntimeError("the compressed proof does not verify")
    return dict(frames=len(frames), **times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100)
    ap.add_argument("rc", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    os.environ.setdefault("LURK_TPU_TRACE", "1")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    r = fib_e2e(args.n, args.rc, args.device)
    e2e = r["prove"] + r["compress"] + r["verify"]
    print(f"fib({args.n}) rc={args.rc} on {args.device}: {r['frames']} "
          f"frames, evaluate {r['evaluate']:.1f} s; E2E {e2e:.1f} s (prove "
          f"{r['prove']:.1f} + compress {r['compress']:.1f} + verify "
          f"{r['verify']:.1f}), {r['frames'] / e2e:.2f} frames/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
