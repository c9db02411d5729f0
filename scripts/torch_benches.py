"""The reference's bench suite on the port (benches/{end2end,synthesis,
public_params,trie_nivc}.rs; the port of the JAX package's
``examples/benches.py``). Each workload times the stages the
reference's criterion groups time and prints one JSON line a
measurement, with the JAX script's keys: ``bench``, ``stage``,
``seconds`` (host clock, after a synchronize on the card) and its
extras.

Usage: ``python3 scripts/torch_benches.py [end2end|synthesis|
public-params|trie-nivc|all] [--rc N] [--device cuda|cpu]`` from the
root of the repo (defaults all, rc 10, cuda; without a card and without
``--device cpu`` it exits 1).

- end2end: ``go_base(10, 16)`` (443 frames) read, evaluated, hydrated,
  proved by ``SuperNovaCycleProver``, compressed and verified.
- synthesis: one ``MultiFrame.instance(witness_only=True)`` at rc, on
  fib(max(1, rc // 3)).
- public-params: ``sn_cycle_public_params`` cold, then warm (loaded from
  the disk as a new process would), in a temporary ``$LURK_TPU_CACHE``.
- trie-nivc: the trie program (1,590 frames) evaluated under
  ``LangSetup.nivc``, its result 12688603180 checked, proved through
  ``SuperNovaCycleProver`` and verified.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from lurk_tpu_torch.device import resolve_device  # noqa: E402
from lurk_tpu_torch.examples import (  # noqa: E402
    TRIE_PROGRAM, TRIE_RESULT, go_base,
)
from lurk_tpu_torch.fields import BN256_SCALAR  # noqa: E402
from lurk_tpu_torch.lem import evaluation as ev  # noqa: E402
from lurk_tpu_torch.parser import read_with_default_state  # noqa: E402
from lurk_tpu_torch.proof import hyperkzg  # noqa: E402
from lurk_tpu_torch.proof import prover_supernova_cycle as psc  # noqa: E402
from lurk_tpu_torch.store.core import Store  # noqa: E402

WHICH = ["end2end", "synthesis", "public-params", "trie-nivc", "all"]


def _emit(name: str, stage: str, seconds: float, **extra) -> dict:
    rec = {"bench": name, "stage": stage, "seconds": round(seconds, 4)}
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


class _Clock:
    """Host-clock seconds since the last ``lap``, after a synchronize
    when the work ran on the card."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        dt, self.t0 = t - self.t0, t
        return dt


def bench_end2end(rc: int, device) -> list:
    """end2end.rs: store (read), evaluate, hydrate, prove, compress and
    verify ``go_base(10, 16)``; returns the emitted records. Raises if the
    compressed proof does not verify."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    store = Store(BN256_SCALAR, dev)
    expr = read_with_default_state(store, go_base(10, 16))
    recs = [_emit("end2end", "store", clock.lap())]
    frames = ev.evaluate(None, expr, store, 1_000_000)
    recs.append(_emit("end2end", "eval", clock.lap(), frames=len(frames)))
    store.hydrate_z_cache()
    recs.append(_emit("end2end", "hydration", clock.lap()))
    prover = psc.SuperNovaCycleProver(rc=rc, device=dev)
    clock.lap()
    pp, proof = prover.prove_from_frames(store, frames)
    recs.append(_emit("end2end", "prove", clock.lap(), rc=rc))
    comp = psc.compress_sn_cycle(pp, proof)
    recs.append(_emit("end2end", "compress", clock.lap()))
    ok = psc.verify_compressed_sn_cycle(pp, comp)
    recs.append(_emit("end2end", "verify", clock.lap(), ok=ok))
    if not ok:
        raise RuntimeError("end2end: the compressed proof does not verify")
    return recs


def synthesis_program(rc: int) -> str:
    """The synthesis bench's program: fib(max(1, rc // 3)) by a loop
    that stops at its target."""
    fib_n = max(1, rc // 3)
    return ("(letrec ((next (lambda (a b n target) "
            "(if (eq n target) a (next b (+ a b) (+ 1 n) target)))) "
            f"(fib (next 0 1 0))) (fib {fib_n}))")


def bench_synthesis(rc: int, device, store: Store = None):
    """synthesis.rs: one MultiFrame's witness synthesis at ``rc``
    (witness only, the reference's WitnessCS). The program is read into
    ``store`` (a new one on ``device`` by default) and hydrated first.
    Returns ``(record, witness)``."""
    from lurk_tpu_torch.lem.eval_step import eval_step
    from lurk_tpu_torch.proof.multiframe import MultiFrame
    dev = resolve_device(device)
    if store is None:
        store = Store(BN256_SCALAR, dev)
    expr = read_with_default_state(store, synthesis_program(rc))
    frames = ev.evaluate(None, expr, store, 1_000_000)
    store.hydrate_z_cache()
    step = eval_step()
    mf = MultiFrame.from_frames(frames, rc, step, store)[0]
    t0 = time.perf_counter()
    _, w, _ = mf.instance(step, store, witness_only=True)
    rec = _emit("synthesis", "witness", time.perf_counter() - t0, rc=rc,
                frames=len(mf.frames))
    return rec, w


def bench_public_params(rc: int, device) -> dict:
    """public_params.rs: the SuperNova cycle's public parameters at
    ``rc``, cold (built and saved) then warm (loaded from the disk cache),
    in a temporary ``$LURK_TPU_CACHE`` restored after. The in-memory
    caches (the parameters and the SRS) are emptied before each, as in
    a new process. Returns the records and the files the cold run left
    in the cache."""
    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="pp_bench_")
    old = os.environ.get("LURK_TPU_CACHE")
    os.environ["LURK_TPU_CACHE"] = tmp
    try:
        store = Store(BN256_SCALAR, dev)
        prover = psc.SuperNovaCycleProver(rc=rc, device=dev)
        lurk_step, cprocs = prover.setup_funcs()
        clock = _Clock(dev)
        recs, files = [], None
        for stage in ("cold", "warm"):
            psc._PP_CACHE.clear()
            hyperkzg._SRS_MEM.clear()
            clock.lap()
            psc.sn_cycle_public_params(store, rc, lurk_step, cprocs, None,
                                       dev)
            recs.append(_emit("public_params", stage, clock.lap(), rc=rc))
            if files is None:
                files = sorted(str(p.relative_to(tmp))
                               for p in pathlib.Path(tmp).rglob("*")
                               if p.is_file())
    finally:
        if old is None:
            os.environ.pop("LURK_TPU_CACHE", None)
        else:
            os.environ["LURK_TPU_CACHE"] = old
        shutil.rmtree(tmp, ignore_errors=True)
    return {"records": recs, "files": files}


def trie_evaluate(device):
    """The trie program read and evaluated under ``LangSetup.nivc`` on a
    new store; raises unless its result is the reference's 12688603180.
    Returns ``(store, lang, frames, seconds)``."""
    from lurk_tpu_torch.coproc.trie import install_trie_lang
    dev = resolve_device(device)
    store = Store(BN256_SCALAR, dev)
    lang, *_ = install_trie_lang()
    expr = read_with_default_state(store, TRIE_PROGRAM)
    t0 = time.perf_counter()
    frames = ev.evaluate(ev.LangSetup.nivc(lang), expr, store, 1_000_000)
    seconds = time.perf_counter() - t0
    got = store.fetch_num(frames[-1].output[0])
    if got != TRIE_RESULT:
        raise RuntimeError(f"trie result {got} != reference {TRIE_RESULT}")
    return store, lang, frames, seconds


def trie_prove(rc: int, store: Store, lang, frames, device):
    """The trie program's frames proved through
    ``SuperNovaCycleProver(rc, lang)`` and verified; returns ``(pp,
    proof, seconds of the prove)``. Raises if the proof does not
    verify."""
    dev = resolve_device(device)
    prover = psc.SuperNovaCycleProver(rc=rc, lang=lang, device=dev)
    clock = _Clock(dev)
    pp, proof = prover.prove_from_frames(store, frames)
    seconds = clock.lap()
    if not psc.SuperNovaCycleProver.verify(pp, proof):
        raise RuntimeError("trie-nivc: the proof does not verify")
    return pp, proof, seconds


def bench_trie_nivc(rc: int, device) -> list:
    """trie_nivc.rs: evaluate the trie program, check the reference's
    result, prove at ``rc`` and verify; returns the emitted records."""
    store, lang, frames, t_eval = trie_evaluate(device)
    recs = [_emit("trie_nivc", "eval", t_eval, frames=len(frames))]
    _, _, t_prove = trie_prove(rc, store, lang, frames, device)
    recs.append(_emit("trie_nivc", "prove", t_prove, rc=rc))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=WHICH)
    ap.add_argument("--rc", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    if args.which in ("end2end", "all"):
        bench_end2end(args.rc, dev)
    if args.which in ("synthesis", "all"):
        bench_synthesis(args.rc, dev)
    if args.which in ("public-params", "all"):
        bench_public_params(args.rc, dev)
    if args.which in ("trie-nivc", "all"):
        bench_trie_nivc(args.rc, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
