"""Nova IVC prover (augmented circuits) over the universal Lurk step:
the ``nova`` backend, with its Spartan compression.

The port of the JAX package's ``proof/prover_cycle.py``: evaluate ->
MultiFrames -> each chunk becomes the step function of one primary
augmented synthesis -> dual-chain folding (:mod:`.nova_cycle`) ->
compression (:func:`compress_cycle`, Spartan over both final
accumulators) and its verifier. Reference functionality: the
RecursiveSNARK over the augmented MultiFrame StepCircuit, reference
src/proof/nova.rs:260-373.

Both curves commit on ``device`` (default ``cuda``). Step witnesses
come from the fork pool of :mod:`.witness_pool` while ``check_steps``
is off and there are at least 3 chunks (the JAX package's default); the
time the parent waits for each goes to :mod:`..utils.metrics` as
``nova_cycle.witness``. A ``Lang``'s coprocessors run inside the
universal step (IVC: ``make_eval_step(specs, True)``), each through its
circuit; a coprocessor with no circuit makes the prove raise
``SynthesisError``. ``prove_incremental`` folds into a running
accumulator and returns it live: the chain server's stream extends one
proof across calls.
"""

from __future__ import annotations

import dataclasses
import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..device import resolve_device
from ..lem import evaluation as ev
from ..lem import ir
from ..lem.eval_step import make_eval_step
from ..lem.interpreter import Frame
from ..store.core import Ptr, Store
from ..utils import metrics
from ..utils import tracing
from ..utils.tracing import instrument
from . import spartan, witness_pool
from .multiframe import MultiFrame
from .nova import PublicParams, R1CSInstance, RelaxedInstance
from .nova_cycle import (
    CycleProof, CyclePublicParams, CycleSNARK, chain_heads_ok, fold_pending,
)
from .nova_cycle import verify as cycle_verify
from .params_cache import lang_circuits, lang_key, shape_cache_key


def multiframe_step_fn(lurk_step: ir.Func,
                       cproc_synthesizers: Optional[Dict] = None):
    """Step callback for the primary augmented circuit: rc chained Lurk
    frame syntheses (multiframe.rs:596-712), inputs and outputs as the
    6-scalar z vector. The STORE travels in step_aux, ``(frames,
    store)``, so cached public params stay valid across stores."""
    from ..lem.circuit import AllocatedPtr, synthesize_frame_with_inputs

    def step(cs, zi, aux):
        frames, store = aux
        current = [AllocatedPtr(zi[2 * i], zi[2 * i + 1])
                   for i in range(3)]
        for frame in frames:
            current = synthesize_frame_with_inputs(
                cs, lurk_step, store, frame, current, cproc_synthesizers)
        out = []
        for ptr in current:
            out.extend((ptr.tag, ptr.hash))
        return out

    return step


_PP_CACHE: Dict[tuple, CyclePublicParams] = {}


def cycle_public_params(store: Store, rc: int, lurk_step: ir.Func,
                        lang: Optional[ev.Lang] = None,
                        device=None) -> CyclePublicParams:
    """The public parameters of ``lang`` at ``rc``, with keys on
    ``device``; cached per process, the shapes on disk. The shapes are
    synthesized on a nil evaluation padded to rc (the uniform-shape
    property, pinned by tests)."""
    dev = resolve_device(device)
    key = (store.field.name, rc, lang_circuits(lang), dev)
    pp = _PP_CACHE.get(key)
    if pp is not None:
        return pp
    nil = store.intern_nil()
    frames = ev.evaluate(None, nil, store, rc)
    store.hydrate_z_cache()
    mfs = MultiFrame.from_frames(frames, rc, lurk_step, store, lang)
    base = shape_cache_key(store.field.name, rc, lurk_step) + \
        hashlib.sha256(repr(lang_key(lang)).encode()).hexdigest()[:8]
    synths = lang.circuit_synthesizers() if lang is not None else None
    pp = CyclePublicParams.setup(
        store.field, 6, multiframe_step_fn(lurk_step, synths), mfs[0].z_in,
        (mfs[0].frames, store), cache_base=base, device=dev)
    _PP_CACHE[key] = pp
    return pp


@dataclasses.dataclass
class CycleNovaProver:
    """IVC prover: one augmented fold step per rc-frame chunk."""

    rc: int = 10
    lang: Optional[ev.Lang] = None
    check_steps: bool = False
    device: Optional[str] = None

    def step_func(self) -> ir.Func:
        specs = tuple(self.lang.cproc_specs()) if self.lang else ()
        return make_eval_step(specs, True)

    def evaluate_and_prove(self, store: Store, expr: Ptr,
                           limit: int = 10000
                           ) -> Tuple[CyclePublicParams, CycleProof,
                                      List[Frame]]:
        lang_setup = ev.LangSetup.ivc(self.lang) if self.lang else None
        frames = ev.evaluate(lang_setup, expr, store, limit)
        pp, proof = self.prove_from_frames(store, frames)
        return pp, proof, frames

    @instrument("nova_cycle.prove_from_frames")
    def prove_from_frames(self, store: Store, frames: List[Frame],
                          init: Optional[CycleSNARK] = None
                          ) -> Tuple[CyclePublicParams, CycleProof]:
        pp, snark = self.prove_incremental(store, frames, init)
        return pp, snark.finish()

    def prove_incremental(self, store: Store, frames: List[Frame],
                          init: Optional[CycleSNARK] = None
                          ) -> Tuple[CyclePublicParams, CycleSNARK]:
        """Fold ``frames`` into ``init`` (a new accumulator when None)
        and return it live, so that a caller can fold later frames into
        the same proof (the reference's resumable prove, proof/mod.rs:
        185-187; the chain server carries it across calls,
        chain-server/src/server.rs:445-548). ``snark.finish()`` leaves
        the accumulator as it was. Raises ``ValueError`` when ``init``
        belongs to other public parameters or its state does not chain
        into the first chunk's input."""
        if not frames:
            raise ValueError("no frames to prove")
        store.hydrate_z_cache()
        step = self.step_func()
        mframes = MultiFrame.from_frames(frames, self.rc, step, store,
                                         self.lang)
        pp = cycle_public_params(store, self.rc, step, self.lang,
                                 self.device)
        if init is None:
            snark = CycleSNARK(pp, mframes[0].z_in)
        else:
            snark = init
            if snark.pp is not pp and snark.pp.pp_digest != pp.pp_digest:
                raise ValueError("the resumed snark belongs to other public "
                                 "parameters")
            if list(snark.zi) != [v % pp.field1.modulus
                                  for v in mframes[0].z_in]:
                raise ValueError("the resumed snark's state does not chain "
                                 "into these frames")
        jobs = self.witness_jobs(store, mframes)
        caches = witness_pool.step_witnesses(store, pp.cfg1.step_fn, jobs,
                                             self.check_steps)
        for mf, (_, aux) in zip(mframes, jobs):
            with metrics.timed("nova_cycle.witness"):
                cache = next(caches)
            snark.prove_step(mf.z_out, step_aux=aux, check=self.check_steps,
                             step_cache=cache)
        return pp, snark

    @staticmethod
    def witness_jobs(store: Store, mframes: List[MultiFrame]):
        """Each step's ``(z_in, step_aux)`` for the primary step
        function, ``step_aux = (frames, store)``."""
        return [(mf.z_in, (mf.frames, store)) for mf in mframes]

    @staticmethod
    def verify(pp: CyclePublicParams, proof: CycleProof) -> bool:
        return cycle_verify(pp, proof)


# ---------------------------------------------------------------------------
# Compression: Spartan/IPA over both final accumulators -> O(log) proof
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedCycleProof:
    n: int
    z0: List[int]
    zn: List[int]
    u1: RelaxedInstance
    u2: RelaxedInstance
    u2_pending: R1CSInstance
    comm_t_last: object
    spartan1: spartan.SpartanProof
    spartan2: spartan.SpartanProof


def _side_pp(pp: CyclePublicParams, which: int) -> PublicParams:
    if which == 1:
        return PublicParams(pp.shape1, pp.curve1, pp.ck1)
    return PublicParams(pp.shape2, pp.curve2, pp.ck2)


@instrument("nova_cycle.compress")
def compress_cycle(pp: CyclePublicParams, proof: CycleProof
                   ) -> CompressedCycleProof:
    """Spartan over the primary accumulator (HyperKZG openings on
    ``ck1``) and over the folded secondary one (IPA on ``ck2``), the
    secondary in a thread: its host C++ calls release the interpreter
    lock, so it overlaps the primary's."""
    def _secondary():
        return spartan.prove(_side_pp(pp, 2), fold_pending(pp, proof),
                             proof.w2_folded)

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut2 = ex.submit(tracing.carried(_secondary))
        sp1 = spartan.prove(_side_pp(pp, 1), proof.u1, proof.w1)
        sp2 = fut2.result()
    return CompressedCycleProof(proof.n, list(proof.z0), list(proof.zn),
                                proof.u1, proof.u2, proof.u2_pending,
                                proof.comm_t_last, sp1, sp2)


@instrument("nova_cycle.verify_compressed")
def verify_compressed_cycle(pp: CyclePublicParams,
                            cp: CompressedCycleProof) -> bool:
    if not chain_heads_ok(pp, cp):
        return False
    u2f = fold_pending(pp, cp)
    if not spartan.verify(_side_pp(pp, 1), cp.u1, cp.spartan1):
        return False
    return spartan.verify(_side_pp(pp, 2), u2f, cp.spartan2)
