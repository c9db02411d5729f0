"""SuperNova NIVC prover (augmented circuits) over the universal Lurk
step circuit: the O(#circuits) ``supernova-cycle`` backend, the JAX
package's default, with its Spartan compression.

The port of the JAX package's ``proof/prover_supernova_cycle.py``:
evaluate -> pc-chunked frames -> each chunk becomes one primary
augmented synthesis for its circuit index -> dual-chain folding
(:mod:`.supernova_cycle`) -> compression (:func:`compress_sn_cycle`,
Spartan over every final accumulator) and its verifier. Reference
functionality: reference src/proof/supernova.rs:200-318 via arecibo.

Both curves commit on ``device`` (default ``cuda``). Step witnesses
come from the fork pool of :mod:`.witness_pool` while ``check_steps``
is off and there are at least 3 chunks (the JAX package's default). The
time the parent waits for each step's witness goes to
:mod:`..utils.metrics` as ``supernova_cycle.witness``.

Only the empty ``Lang`` (the main path) is ported: a ``Lang`` with
coprocessors raises ``NotImplementedError`` until ``coproc/`` is
ported.
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
from ..r1cs.gadgets import alloc_num
from ..store.core import Ptr, Store
from ..utils import metrics
from ..utils.tracing import instrument
from . import spartan, witness_pool
from .multiframe import io_scalars, pad_frames
from .nova import PublicParams
from .nova_cycle import fold_pending
from .params_cache import shape_cache_key
from .supernova import chunk_frames_nivc, no_coprocessors
from .supernova_cycle import (
    SnCycleProof, SnCyclePublicParams, SnCycleSNARK, sn_state1, sn_state2,
)
from .supernova_cycle import verify as sn_cycle_verify


def _chunk_step_fn(func: ir.Func, cproc_synthesizers: Optional[Dict] = None):
    """Primary step callback: chain the chunk's frame syntheses; the
    next circuit index is allocated as advice (multiframe.rs:922-966:
    the reference's supernova StepCircuit also allocates next_pc). The
    STORE travels in step_aux so cached public params stay valid across
    stores."""
    from ..lem.circuit import AllocatedPtr, synthesize_frame_with_inputs

    def step(cs, zi, aux):
        frames, next_pc, store = aux
        current = [AllocatedPtr(zi[2 * i], zi[2 * i + 1])
                   for i in range(3)]
        for frame in frames:
            current = synthesize_frame_with_inputs(
                cs, func, store, frame, current, cproc_synthesizers)
        out = []
        for ptr in current:
            out.extend((ptr.tag, ptr.hash))
        return out, alloc_num(cs, next_pc)

    return step


_PP_CACHE: Dict[tuple, SnCyclePublicParams] = {}


def sn_cycle_public_params(store: Store, rc: int, lurk_step: ir.Func,
                           cprocs: List[ir.Func],
                           lang: Optional[ev.Lang] = None,
                           device=None) -> SnCyclePublicParams:
    """The public parameters of the empty ``Lang`` at ``rc``, with keys
    on ``device``; cached per process, the shapes on disk."""
    no_coprocessors(lang)
    dev = resolve_device(device)
    lang_key = ()
    key = (store.field.name, rc, lang_key, dev)
    pp = _PP_CACHE.get(key)
    if pp is not None:
        return pp
    step_fns = [_chunk_step_fn(lurk_step)]
    # dummy auxes for shape synthesis
    nil = store.intern_nil()
    frames = ev.evaluate(None, nil, store, rc)
    frames = pad_frames(frames, lurk_step, rc, store, lang)
    store.hydrate_z_cache()
    dummy_auxes = [(frames, 0, store)]
    dummy_z0 = io_scalars(store, frames[0].input)
    base = shape_cache_key(store.field.name, rc, lurk_step) + \
        hashlib.sha256(repr(lang_key).encode()).hexdigest()[:8]
    pp = SnCyclePublicParams.setup(store.field, 6, step_fns, dummy_z0,
                                   dummy_auxes, cache_base=base,
                                   device=dev)
    _PP_CACHE[key] = pp
    return pp


@dataclasses.dataclass
class SuperNovaCycleProver:
    """NIVC prover: one augmented fold step per pc chunk."""

    rc: int = 10
    lang: Optional[ev.Lang] = None
    check_steps: bool = False
    device: Optional[str] = None

    def setup_funcs(self) -> Tuple[ir.Func, List[ir.Func]]:
        no_coprocessors(self.lang)
        return make_eval_step((), False), []

    def evaluate_and_prove(self, store: Store, expr: Ptr,
                           limit: int = 10000):
        no_coprocessors(self.lang)
        frames = ev.evaluate(None, expr, store, limit)
        pp, proof = self.prove_from_frames(store, frames)
        return pp, proof, frames

    def chunks(self, store: Store, frames: List[Frame]) -> List[List[Frame]]:
        """The frames cut into the steps' chunks, a short pc-0 chunk
        padded to ``rc``."""
        lurk_step, _ = self.setup_funcs()
        padded: List[List[Frame]] = []
        for chunk in chunk_frames_nivc(list(frames), self.rc):
            if chunk[0].pc == 0 and len(chunk) < self.rc:
                chunk = pad_frames(chunk, lurk_step, self.rc, store,
                                   self.lang)
            padded.append(chunk)
        return padded

    @instrument("supernova_cycle.prove_from_frames")
    def prove_from_frames(self, store: Store, frames: List[Frame]
                          ) -> Tuple[SnCyclePublicParams, SnCycleProof]:
        if not frames:
            raise ValueError("no frames to prove")
        store.hydrate_z_cache()
        lurk_step, cprocs = self.setup_funcs()
        padded = self.chunks(store, frames)
        pp = sn_cycle_public_params(store, self.rc, lurk_step, cprocs,
                                    self.lang, self.device)
        jobs = self.witness_jobs(store, padded)
        snark = SnCycleSNARK(pp, jobs[0][0])
        # one primary circuit: a Lang with coprocessors raises
        caches = witness_pool.step_witnesses(store, pp.cfg1s[0].step_fn,
                                             jobs, self.check_steps)
        for (_, aux), chunk in zip(jobs, padded):
            with metrics.timed("supernova_cycle.witness"):
                cache = next(caches)
            if cache is not None:
                seg, (outs, pc_next) = cache
                cache = (seg, outs, pc_next)
            snark.prove_step(chunk[0].pc, io_scalars(store, chunk[-1].output),
                             aux[1], step_aux=aux, check=self.check_steps,
                             step_cache=cache)
        return pp, snark.finish()

    @staticmethod
    def witness_jobs(store: Store, padded: List[List[Frame]]):
        """Each step's ``(z_in, step_aux)`` for the primary step
        function, ``step_aux = (chunk, next pc, store)``."""
        return [(io_scalars(store, chunk[0].input),
                 (chunk, padded[k + 1][0].pc if k + 1 < len(padded) else 0,
                  store))
                for k, chunk in enumerate(padded)]

    @staticmethod
    def verify(pp: SnCyclePublicParams, proof: SnCycleProof) -> bool:
        return sn_cycle_verify(pp, proof)


# ---------------------------------------------------------------------------
# Compression: Spartan/IPA over every final accumulator -> O(log) proof
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedSnCycleProof:
    n: int
    z0: List[int]
    zn: List[int]
    pc_n: int
    u1s: List[object]             # RelaxedInstance per circuit
    u2: object
    u2_pending: object
    comm_t_last: object
    spartans1: List[object]       # SpartanProof per primary circuit
    spartan2: object


def _side_pp1(pp: SnCyclePublicParams, pc: int) -> PublicParams:
    return PublicParams(pp.shapes1[pc], pp.curve1, pp.ck1)


def _side_pp2(pp: SnCyclePublicParams) -> PublicParams:
    return PublicParams(pp.shape2, pp.curve2, pp.ck2)


def compress_sn_cycle(pp: SnCyclePublicParams, proof: SnCycleProof
                      ) -> CompressedSnCycleProof:
    """Spartan over each primary accumulator (HyperKZG openings on
    ``ck1``) and over the folded secondary one (IPA on ``ck2``), the
    secondary in a thread: its host C++ calls release the interpreter
    lock, so it overlaps the primary's."""
    def _secondary():
        return spartan.prove(_side_pp2(pp), fold_pending(pp, proof),
                             proof.w2_folded)

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut2 = ex.submit(_secondary)
        spartans1 = [spartan.prove(_side_pp1(pp, pc), proof.u1s[pc],
                                   proof.w1s[pc])
                     for pc in range(pp.n_circuits)]
        sp2 = fut2.result()
    return CompressedSnCycleProof(
        proof.n, list(proof.z0), list(proof.zn), proof.pc_n,
        list(proof.u1s), proof.u2, proof.u2_pending, proof.comm_t_last,
        spartans1, sp2)


def verify_compressed_sn_cycle(pp: SnCyclePublicParams,
                               cp: CompressedSnCycleProof) -> bool:
    if cp.n <= 0 or len(cp.u1s) != pp.n_circuits:
        return False
    if len(cp.spartans1) != pp.n_circuits:
        return False
    if len(cp.z0) != pp.io_arity or len(cp.zn) != pp.io_arity:
        return False
    if len(cp.u2_pending.x) != 2 or len(cp.u2.x) != 2 or \
            any(len(u.x) != 2 for u in cp.u1s):
        return False
    h_n = sn_state1(pp.curve2, pp.pp_digest, cp.n, cp.z0, cp.zn,
                    cp.pc_n, cp.u2, cp.u2_pending.x[0])
    g_n = sn_state2(pp.curve1, pp.pp_digest, cp.n, cp.u1s, h_n)
    if cp.u2_pending.x[1] != g_n:
        return False
    u2f = fold_pending(pp, cp)
    for pc in range(pp.n_circuits):
        if not spartan.verify(_side_pp1(pp, pc), cp.u1s[pc],
                              cp.spartans1[pc]):
            return False
    return spartan.verify(_side_pp2(pp), u2f, cp.spartan2)
