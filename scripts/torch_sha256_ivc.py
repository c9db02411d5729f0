"""Nova IVC proof with the sha256 coprocessor on the port: the program
of the reference's examples/sha256_ivc.rs (and of the JAX package's
``examples/sha256_ivc.py``), ``(sha256_ivc_<n> 1 .. n)`` evaluated under
``LangSetup.ivc`` and proved at rc = 10 by ``NovaProver``, whose one
universal step circuit inlines the coprocessor (unlike
``torch_sha256_nivc.py``'s circuit a coprocessor).

Usage: ``python3 scripts/torch_sha256_ivc.py [n_args] [--device
cuda|cpu]`` from the root of the repo. The device is ``cuda`` unless
``--device cpu`` is given; without a card the script exits 1. It prints
one line: the frames and the evaluate + prove + verify seconds (host
clock).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from lurk_tpu_torch.coproc.sha256 import sha256_coprocessor  # noqa: E402
from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.fields import BN256_SCALAR  # noqa: E402
from lurk_tpu_torch.lem.evaluation import Lang  # noqa: E402
from lurk_tpu_torch.proof.prover import NovaProver  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402
from lurk_tpu_torch.symbol import user_sym  # noqa: E402


def sha256_ivc_program(n: int, device):
    """``(sha256_ivc_<n> 1 .. n)`` on a new store with the coprocessor in
    a ``Lang``: ``(store, lang, expr)``."""
    store = Store(BN256_SCALAR, resolve_device(device))
    lang = Lang()
    sym = user_sym(f"sha256_ivc_{n}")
    lang.add_coprocessor(sym, sha256_coprocessor(n))
    args = [store.num(i + 1) for i in range(n)]
    return store, lang, store.list([store.intern_symbol(sym)] + args)


def prove_sha256_ivc(n: int, device, rc: int = 10):
    """Evaluate and prove ``(sha256_ivc_<n> 1 .. n)`` through
    ``NovaProver(rc, lang)`` on ``device`` and verify it; returns
    ``(store, pp, proof, frames, seconds)``, the seconds those of the
    evaluation, the prove and the verify. Raises if the proof does not
    verify."""
    dev = resolve_device(device)
    store, lang, expr = sha256_ivc_program(n, dev)
    prover = NovaProver(rc=rc, lang=lang, device=dev)
    t0 = time.perf_counter()
    pp, proof, frames = prover.evaluate_and_prove(store, expr)
    if not NovaProver.verify(pp, proof):
        raise RuntimeError("IVC verification failed")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return store, pp, proof, frames, time.perf_counter() - t0


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
    _, _, _, frames, seconds = prove_sha256_ivc(args.n, device)
    print(f"sha256_ivc_{args.n}: {len(frames)} frames, "
          f"proved+verified in {seconds:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
