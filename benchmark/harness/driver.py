"""The one general job runner: a configuration names the program, its
field, rc, backend and Lang; a traffic mix names the stages of a job
and the inputs' width; the seed draws each job's inputs.

Programs are text with ``{0}``, ``{1}``, .. for the inputs, read by the
port's reader. Backend ``supernova-cycle``:
``SuperNovaCycleProver.prove_from_frames``, ``compress_sn_cycle`` and
``verify_compressed_sn_cycle``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, List, Optional

import torch

from .spans import Recorder


def job_inputs(seed: int, job: int, count: int, bits: int) -> List[int]:
    """Job ``job``'s inputs under ``seed``: the same seed, the same
    inputs, whatever the program does with them."""
    rng = random.Random(f"{seed}:{job}")
    return [rng.getrandbits(bits) for _ in range(count)]


@dataclasses.dataclass
class JobResult:
    index: int
    inputs: List[int]
    t0: float
    t1: float = 0.0
    error: Optional[str] = None
    store: Any = None
    frames: Any = None
    pp: Any = None
    proof: Any = None
    compressed: Any = None
    verified: Optional[bool] = None
    steps: int = 0

    @property
    def failed(self) -> bool:
        return self.error is not None or self.verified is False


class Program:
    """One configuration of the port, ready to run jobs on ``device``."""

    def __init__(self, config: dict, device, rec: Recorder):
        from lurk_tpu_torch.fields import FIELDS
        from lurk_tpu_torch.lem import evaluation as ev
        from lurk_tpu_torch.proof import prover_supernova_cycle as psc
        if config["backend"] != "supernova-cycle":
            raise ValueError(f"unknown backend {config['backend']!r}")
        self.cfg = config
        self.field = FIELDS[config["field"]]
        self.device = torch.device(device)
        self.rec = rec
        self.ev, self.psc = ev, psc
        self.lang = ev.Lang()
        for cp in config.get("lang", []):
            self.lang.add_coprocessor(*_coprocessor(cp))
        self.lang_setup = ev.LangSetup.nivc(self.lang) \
            if config.get("lang") else None
        self.prover = psc.SuperNovaCycleProver(
            rc=config["rc"], lang=self.lang, device=self.device)

    def store(self):
        from lurk_tpu_torch.store.core import Store
        return Store(self.field, self.device)

    def expr(self, store, inputs: List[int]):
        from lurk_tpu_torch.parser import read_with_default_state
        return read_with_default_state(
            store, self.cfg["program"].format(*inputs))

    def public_params(self):
        """Load (or, in a fresh checkout, build) the public parameters
        and build both keys' tables on the device."""
        store = self.store()
        pp = self.psc.sn_cycle_public_params(
            store, self.cfg["rc"], *self.prover.setup_funcs(), self.lang,
            device=self.device)
        pp.ck1.table()
        pp.ck2.table()
        self.sync()
        return pp

    def warm_kernels(self) -> None:
        """Build or load K1 before the window: the store's waves of 64
        or more hash on the device, at arities 4, 6 and 8."""
        from lurk_tpu_torch.poseidon import kernel as K
        for arity in (4, 6, 8):
            K.hash_batch(self.field, arity, [[0] * arity] * 64,
                         device=self.device)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_job(self, index: int, inputs: List[int], stages,
                frame_limit: int) -> JobResult:
        rec = self.rec
        res = JobResult(index, list(inputs), time.perf_counter())
        try:
            store = self.store()
            with rec.span("bench.evaluate"):
                expr = self.expr(store, inputs)
                frames = self.ev.evaluate(self.lang_setup, expr, store,
                                          frame_limit)
                store.hydrate_z_cache()
                self.sync()
            res.store, res.frames = store, frames
            if "prove" in stages:
                with rec.span("bench.prove"):
                    res.pp, res.proof = self.prover.prove_from_frames(
                        store, frames)
                    self.sync()
                res.steps = res.proof.n
            if "compress" in stages:
                with rec.span("bench.compress"):
                    res.compressed = self.psc.compress_sn_cycle(
                        res.pp, res.proof)
                    self.sync()
            if "verify" in stages:
                with rec.span("bench.verify"):
                    if res.compressed is not None:
                        res.verified = self.psc.verify_compressed_sn_cycle(
                            res.pp, res.compressed)
                    else:
                        res.verified = self.prover.verify(res.pp, res.proof)
                    self.sync()
        except Exception as err:     # a job that raises counts as failed
            res.error = f"{type(err).__name__}: {err}"
        res.t1 = time.perf_counter()
        return res


def _coprocessor(entry: dict):
    if entry["kind"] == "sha256":
        from lurk_tpu_torch.coproc.sha256 import sha256_coprocessor
        from lurk_tpu_torch.symbol import user_sym
        return user_sym(entry["symbol"]), sha256_coprocessor(entry["arity"])
    raise ValueError(f"unknown coprocessor kind {entry['kind']!r}")
