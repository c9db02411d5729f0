"""SuperNova-style non-uniform IVC (NIVC): the ``supernova`` backend and
the frame chunking the cycle prover shares.

The port of the JAX package's ``proof/supernova.py`` (reference
functionality: src/proof/supernova.rs): per-step circuit selection by
program counter, with one running relaxed accumulator per circuit in
the ``Lang``. As in the JAX package, the verifier recomputes the fold
chain (the in-circuit NIVC verifier is the SuperNova cycle,
:mod:`.supernova_cycle`).

MultiFrame chunking follows reference multiframe.rs:300-360: IVC-style
chunks of `rc` frames at pc=0, broken at coprocessor frames (pc != 0),
which form singleton chunks proven against their own circuit.

The key commits on ``device`` (default ``cuda``). Each circuit's fold
is a :class:`.nova.RecursiveSNARK` over that circuit's view of the
public parameters: W packed once and T as packed words reach K6 with no
Python ints, and each step's phases go to :mod:`..utils.metrics` under
``nova.*``; the prover adds ``supernova.shape``, ``supernova.shape_save``
and ``supernova.witness`` (each later step's inline synthesis: the JAX
NIVC prover has no pool). A ``Lang``'s coprocessors each get their own
circuit (pc >= 1: ``run_cproc`` with the coprocessor's synthesizer), the
first step of each circuit synthesized in full for its shape; a
coprocessor with no circuit makes the prove raise ``SynthesisError``.
Left out of the JAX module: ``FoldingConfig``, which nothing reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..curves.weierstrass import CURVE_FOR_FIELD, Affine, Curve
from ..lem import ir
from ..lem.eval_step import make_cprocs_funcs, make_eval_step
from ..lem.evaluation import Lang, LangSetup, evaluate
from ..lem.interpreter import Frame
from ..store.core import Ptr, Store
from ..utils import metrics
from ..utils.tracing import instrument
from . import spartan
from .multiframe import MultiFrame, io_scalars, pad_frames
from .nova import (
    CommitmentKey, PublicParams, R1CSInstance, R1CSShape, RecursiveSNARK,
    RelaxedInstance, RelaxedWitness, check_relaxed, fold_challenge,
    fold_instance,
)
from .params_cache import load_shape, save_shape, shape_cache_key


def chunk_frames_nivc(frames: List[Frame], rc: int) -> List[List[Frame]]:
    """Chunks of up to rc pc=0 frames; pc!=0 frames are singletons
    (multiframe.rs:300-360)."""
    chunks: List[List[Frame]] = []
    acc: List[Frame] = []
    for frame in frames:
        if frame.pc == 0:
            acc.append(frame)
            if len(acc) == rc:
                chunks.append(acc)
                acc = []
        else:
            if acc:
                chunks.append(acc)
                acc = []
            chunks.append([frame])
    if acc:
        chunks.append(acc)
    return chunks


@dataclasses.dataclass
class NivcStep:
    """One NIVC folding step: a MultiFrame bound to a circuit index."""

    pc: int
    mframe: MultiFrame


@dataclasses.dataclass
class SuperNovaPublicParams:
    """Per-circuit shapes and one key (supernova.rs:39-58)."""

    shapes: Dict[int, R1CSShape]
    ck: CommitmentKey
    curve: Curve

    @staticmethod
    def setup(shapes: Dict[int, R1CSShape],
              device=None) -> "SuperNovaPublicParams":
        """The key of the next power of two above every shape's widths
        (Spartan opens pow2-padded vectors), committing on ``device``."""
        curve = CURVE_FOR_FIELD[next(iter(shapes.values())).field.name]
        n = max(max(s.num_aux, s.num_constraints, s.num_inputs, 2)
                for s in shapes.values())
        ck = CommitmentKey.setup(curve,
                                 b"lurk_tpu.ck." + curve.name.encode(),
                                 1 << (n - 1).bit_length(), device)
        return SuperNovaPublicParams(shapes, ck, curve)

    def params_for(self, pc: int) -> PublicParams:
        """Circuit ``pc``'s single-circuit view, for its fold and its
        compression."""
        return PublicParams(self.shapes[pc], self.curve, self.ck)


@dataclasses.dataclass
class NivcProof:
    """Per-step (pc, instance, comm_T) + final per-circuit witnesses."""

    steps: List[Tuple[int, R1CSInstance, Affine]]
    final_witnesses: Dict[int, RelaxedWitness]
    z0: List[int]
    zi: List[int]


class SuperNovaProver:
    """NIVC prover over the Lurk step and one circuit per coprocessor."""

    def __init__(self, rc: int, lang: Lang, check_steps: bool = False,
                 device=None):
        self.rc = rc
        self.lang = lang
        self.check_steps = check_steps
        self.device = device
        specs = tuple(lang.cproc_specs())
        self.lurk_step = make_eval_step(specs, False)
        self.cprocs = make_cprocs_funcs(specs)

    def setup(self) -> LangSetup:
        return LangSetup(self.lurk_step, self.cprocs, self.lang)

    def _step_func(self, pc: int) -> ir.Func:
        return self.lurk_step if pc == 0 else self.cprocs[pc - 1]

    def steps(self, store: Store, frames: List[Frame]) -> List[NivcStep]:
        """The frames cut into the steps' MultiFrames, a short pc-0
        chunk padded to rc: the step function stutters on
        Terminal/Error and on pending Cproc expressions
        (multiframe.rs:330-346)."""
        steps = []
        for chunk in chunk_frames_nivc(list(frames), self.rc):
            pc = chunk[0].pc
            if pc == 0 and len(chunk) < self.rc:
                chunk = pad_frames(chunk, self.lurk_step, self.rc, store,
                                   self.lang)
            steps.append(NivcStep(pc, MultiFrame(
                chunk, io_scalars(store, chunk[0].input),
                io_scalars(store, chunk[-1].output))))
        return steps

    @instrument("supernova.prove_from_frames")
    def prove_from_frames(self, store: Store, frames: List[Frame]
                          ) -> Tuple[SuperNovaPublicParams, NivcProof]:
        if not frames:
            raise ValueError("no frames to prove")
        store.hydrate_z_cache()
        steps = self.steps(store, frames)
        synths = self.lang.circuit_synthesizers()
        # the empty Lang's pc-0 shape from the disk cache, so that repeat
        # proves are witness-only everywhere; else each circuit's shape
        # from the full synthesis of its first step (pc 0's saved)
        shapes: Dict[int, R1CSShape] = {}
        skey = None
        if not self.check_steps and not len(self.lang):
            skey = shape_cache_key(store.field.name, self.rc,
                                   self.lurk_step) + "-nivc"
            cached = load_shape(skey, store.field)
            if cached is not None:
                shapes[0] = cached
                skey = None
        first: Dict[int, Tuple[List[int], List[int]]] = {}
        for k, step in enumerate(steps):
            if step.pc in shapes:
                continue
            with metrics.timed("supernova.shape"):
                x, w, cs = step.mframe.instance(
                    self._step_func(step.pc), store,
                    shape_check=self.check_steps,
                    cproc_synthesizers=synths)
                shapes[step.pc] = R1CSShape(cs)
            first[k] = (x, w)
            if step.pc == 0 and skey is not None:
                with metrics.timed("supernova.shape_save"):
                    save_shape(skey, shapes[0])
        pp = SuperNovaPublicParams.setup(shapes, self.device)
        # one running accumulator per circuit index
        snarks = {pc: RecursiveSNARK(pp.params_for(pc)) for pc in shapes}
        proof_steps = []
        for k, step in enumerate(steps):
            if k in first:
                x, w = first.pop(k)
            else:
                with metrics.timed("supernova.witness"):
                    x, w, cs = step.mframe.instance(
                        self._step_func(step.pc), store,
                        shape_check=self.check_steps,
                        cproc_synthesizers=synths,
                        witness_only=not self.check_steps)
                if self.check_steps and \
                        cs.shape_digest() != shapes[step.pc].digest:
                    raise ValueError(f"non-uniform circuit for pc={step.pc}")
            rs = snarks[step.pc]
            rs.prove_step(x, w, check=self.check_steps)
            inst, comm_t = rs.steps[-1]
            proof_steps.append((step.pc, inst, comm_t))
        proof = NivcProof(proof_steps,
                          {pc: rs.acc_wit for pc, rs in snarks.items()},
                          steps[0].mframe.z_in, steps[-1].mframe.z_out)
        return pp, proof

    def evaluate_and_prove(self, store: Store, expr: Ptr,
                           limit: int = 10000):
        frames = evaluate(self.setup(), expr, store, limit)
        pp, proof = self.prove_from_frames(store, frames)
        return pp, proof, frames


def _io_chain_ok(steps, z0, zi) -> bool:
    """The step IO linkage across ALL steps in order (z_out == next
    z_in) plus the z0/zi endpoints; each step's input is z_in ++ z_out
    at z0's arity (6 scalars for the Lurk step, 12 for a memoset's)."""
    n = len(z0)
    xs = [inst.x for _, inst, _ in steps]
    if not xs or any(len(x) != 2 * n for x in xs) or \
            xs[0][:n] != list(z0):
        return False
    for prev, cur in zip(xs, xs[1:]):
        if prev[n:] != cur[:n]:
            return False
    return xs[-1][n:] == list(zi)


def _fold_chains(pp: SuperNovaPublicParams, steps
                 ) -> Optional[Dict[int, RelaxedInstance]]:
    """Recompute the per-circuit fold chains; None on malformed IO."""
    acc: Dict[int, RelaxedInstance] = {
        pc: RelaxedInstance.default(s) for pc, s in pp.shapes.items()}
    for pc, inst, comm_t in steps:
        shape = pp.shapes.get(pc)
        if shape is None or len(inst.x) != shape.num_inputs - 1:
            return None
        r = fold_challenge(pp.curve, shape.digest, acc[pc], inst, comm_t)
        acc[pc] = fold_instance(pp.curve, acc[pc], inst, comm_t, r,
                                shape.p)
    return acc


def verify(pp: SuperNovaPublicParams, proof: NivcProof) -> bool:
    """Recompute the per-circuit fold chains + IO linkage, then check all
    final relaxed witnesses and commitment consistency (W and E of each
    circuit recommitted)."""
    if not _io_chain_ok(proof.steps, proof.z0, proof.zi):
        return False
    acc = _fold_chains(pp, proof.steps)
    if acc is None:
        return False
    for pc, shape in pp.shapes.items():
        wit = proof.final_witnesses.get(pc)
        if wit is None or len(wit.w) != shape.num_aux or \
                len(wit.e) != shape.num_constraints:
            return False
        if not check_relaxed(shape, acc[pc], wit):
            return False
        if pp.ck.commit(wit.w) != acc[pc].comm_w:
            return False
        if pp.ck.commit(wit.e) != acc[pc].comm_e:
            return False
    return True


# ---------------------------------------------------------------------------
# Compression (CompressedSNARK over every per-circuit accumulator)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedNivcProof:
    """Fold chain + one Spartan proof per circuit index. The reference
    batches the per-circuit Spartan instances into one
    BatchedRelaxedR1CSSNARK (supernova.rs:163-198); per-circuit proofs
    are functionally equivalent (the JAX package's documented deviation:
    the proof is #circuits x larger, verification identical)."""

    steps: List[Tuple[int, R1CSInstance, Affine]]
    spartans: Dict[int, spartan.SpartanProof]
    z0: List[int]
    zi: List[int]


def compress(pp: SuperNovaPublicParams,
             proof: NivcProof) -> CompressedNivcProof:
    if not proof.steps:
        raise ValueError("cannot compress an empty NIVC fold chain")
    acc = _fold_chains(pp, proof.steps)
    if acc is None:
        raise ValueError("the fold chain does not match the parameters")
    # circuits never folded keep the default accumulator, which has no
    # commitments to open; only prove circuits that appeared
    used = {pc for pc, _, _ in proof.steps}
    spartans = {
        pc: spartan.prove(pp.params_for(pc), acc[pc],
                          proof.final_witnesses[pc])
        for pc in sorted(used)
    }
    return CompressedNivcProof(proof.steps, spartans, proof.z0, proof.zi)


def verify_compressed(pp: SuperNovaPublicParams,
                      proof: CompressedNivcProof) -> bool:
    if not proof.steps:
        return False
    if not _io_chain_ok(proof.steps, proof.z0, proof.zi):
        return False
    acc = _fold_chains(pp, proof.steps)
    if acc is None:
        return False
    used = {pc for pc, _, _ in proof.steps}
    if set(proof.spartans) != used:
        return False
    for pc in used:
        if not spartan.verify(pp.params_for(pc), acc[pc],
                              proof.spartans[pc]):
            return False
    return True
