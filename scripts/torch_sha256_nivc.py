"""SuperNova NIVC proof with the sha256 coprocessor on the port: the
program of the reference's examples/sha256_nivc.rs:59-100 (and of the
JAX package's ``examples/sha256_nivc.py``), ``(sha256_nivc_<n> 1 .. n)``
at rc = 10, proved with ``SuperNovaProver`` and verified.

Usage: ``python3 scripts/torch_sha256_nivc.py [n_args] [--device
cuda|cpu]`` from the root of the repo. The device is ``cuda`` unless
``--device cpu`` is given; without a card the script exits 1. It prints
one line: the frames, the NIVC steps and their circuits, and the prove
+ verify seconds (host clock).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lurk_tpu_torch.coproc.sha256 import (  # noqa: E402
    sha256_coprocessor, sha256_nivc_symbol,
)
from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.fields import BN256_SCALAR  # noqa: E402
from lurk_tpu_torch.lem.evaluation import Lang  # noqa: E402
from lurk_tpu_torch.proof import supernova as sn  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402


def prove_sha256_nivc(n: int, device, rc: int = 10):
    """Evaluate and prove ``(sha256_nivc_<n> 1 .. n)`` on ``device``;
    returns ``(store, pp, proof, frames, seconds)``, the seconds those of
    the prove and the verify. Raises if the proof does not verify."""
    store = Store(BN256_SCALAR, device)
    lang = Lang()
    sym = sha256_nivc_symbol(n)
    lang.add_coprocessor(sym, sha256_coprocessor(n))
    args = [store.num(i + 1) for i in range(n)]
    expr = store.list([store.intern_symbol(sym)] + args)
    prover = sn.SuperNovaProver(rc=rc, lang=lang, device=device)
    t0 = time.time()
    pp, proof, frames = prover.evaluate_and_prove(store, expr)
    if not sn.verify(pp, proof):
        raise RuntimeError("NIVC verification failed")
    return store, pp, proof, frames, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1,
                    help="the coprocessor's arity (default 1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    _, _, proof, frames, seconds = prove_sha256_nivc(args.n, device)
    pcs = sorted({pc for pc, _, _ in proof.steps})
    print(f"sha256_nivc_{args.n}: {len(frames)} frames, "
          f"{len(proof.steps)} NIVC steps over circuits {pcs}, "
          f"proved+verified in {seconds:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
