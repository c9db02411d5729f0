"""Fibonacci proving benchmark on the port: the reference's headline
workload (benches/{fibonacci.rs,common/fib.rs}; the port of the JAX
package's ``examples/fib.py``). Proves the infinite-stream fib program
for ``fib_limit(n, rc)`` frames (frame(n) = 7 + 7n rounded up to a
multiple of rc) through one backend and verifies it.

Usage: ``python3 scripts/torch_fib.py [n] [rc] [--backend
nova-fold|nova|supernova] [--field bn256] [--device cuda|cpu]`` from
the root of the repo (defaults 100 100 nova-fold bn256 cuda; without a
card and without ``--device cpu`` it exits 1). ``nova-fold`` is
``NovaProver``, ``nova`` ``CycleNovaProver`` and ``supernova``
``SuperNovaProver(lang=Lang())``. It prints the evaluation's and the
prove + verify's frames/s (host clock, after a synchronize), the
reference bench's throughput unit.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit  # noqa: E402
from lurk_tpu_torch.fields import FIELDS  # noqa: E402
from lurk_tpu_torch.lem import evaluation as ev  # noqa: E402
from lurk_tpu_torch.parser import read_with_default_state  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402

BACKENDS = ["nova-fold", "nova", "supernova"]


def prove_and_verify(backend: str, rc: int, store: Store, frames, device):
    """``(pp, proof)`` of ``frames`` through ``backend``'s prover on
    ``device``. Raises if its verifier rejects the proof."""
    if backend == "nova":
        from lurk_tpu_torch.proof.prover_cycle import CycleNovaProver
        pp, proof = CycleNovaProver(rc=rc, device=device).prove_from_frames(
            store, frames)
        ok = CycleNovaProver.verify(pp, proof)
    elif backend == "supernova":
        from lurk_tpu_torch.proof import supernova as sn
        prover = sn.SuperNovaProver(rc=rc, lang=ev.Lang(), device=device)
        pp, proof = prover.prove_from_frames(store, frames)
        ok = sn.verify(pp, proof)
    elif backend == "nova-fold":
        from lurk_tpu_torch.proof.prover import NovaProver
        pp, proof = NovaProver(rc=rc, device=device).prove_from_frames(
            store, frames)
        ok = NovaProver.verify(pp, proof)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if not ok:
        raise RuntimeError("verification failed")
    return pp, proof


def fib(n: int, rc: int, backend: str, field: str, device) -> dict:
    """Evaluate fib(n) and prove and verify it at ``rc`` through
    ``backend`` on ``device``; returns the frames and the evaluation's
    and the prove + verify's seconds."""
    dev = resolve_device(device)
    store = Store(FIELDS[field], dev)
    expr = read_with_default_state(store, FIB_PROGRAM)
    t0 = time.perf_counter()
    frames = ev.evaluate(None, expr, store, fib_limit(n, rc))
    t_eval = time.perf_counter() - t0
    t0 = time.perf_counter()
    prove_and_verify(backend, rc, store, frames, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"frames": len(frames), "eval": t_eval,
            "prove_verify": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=100)
    ap.add_argument("rc", type=int, nargs="?", default=100)
    ap.add_argument("--backend", default="nova-fold", choices=BACKENDS)
    ap.add_argument("--field", default="bn256")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    r = fib(args.n, args.rc, args.backend, args.field, args.device)
    frames = r["frames"]
    print(f"eval: {frames} frames in {r['eval']:.2f}s "
          f"({frames / r['eval']:.0f} frames/s)")
    print(f"prove+verify [{args.backend}, rc={args.rc}]: "
          f"{r['prove_verify']:.1f}s -> {frames / r['prove_verify']:.2f} "
          f"frames/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
