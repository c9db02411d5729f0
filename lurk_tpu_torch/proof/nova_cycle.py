"""Nova IVC proper: dual-chain folding on a curve cycle with augmented
circuits (the in-circuit fold verifier of :mod:`.augmented`).

The port of the JAX package's ``proof/nova_cycle.py``, the ``nova``
backend's fold (reference functionality: arecibo's ``RecursiveSNARK``
with its augmented circuits, driven by reference
src/proof/nova.rs:260-373). The proof is O(1) in the number of steps:
two relaxed accumulators and one pending strict instance. Its host
transcript helpers (``cycle_fold_challenge``, ``cycle_state_hash``,
``_default_relaxed``, :func:`fold_pending`) serve the SuperNova cycle
(:mod:`.supernova_cycle`) too.

Two hash chains, h (primary) and g (secondary), with h_0 = g_0 = 0:

    h_{i+1} = H1(pp, i+1, z0, z_{i+1}, U2_{i+1}, g_i)
    g_{j+1} = H2(pp, j+1, U1_{j+1}, h_{j+1})

The primary circuit at step i opens h_i, folds the pending secondary
instance into U2 in-circuit, runs the step function and binds h_{i+1};
the secondary circuit folds the primary instance into U1 and binds g.
The verifier recomputes h_n and g_n, checks the pending secondary
instance's IO, folds it into U2 on the host and checks both relaxed
accumulators, directly (:func:`verify`) or through Spartan
(:mod:`.prover_cycle`).

Both commitment keys commit on ``device`` (default ``cuda``: K6 on the
card). As in :mod:`.supernova_cycle`, each step packs W1 once,
dispatches its commit before the host cross-term and resolves it after
T1's dispatch, and keeps the primary accumulator's ``Az|Bz|Cz`` cached,
folded forward with one RLC. Each phase's host-clock seconds go to
:mod:`..utils.metrics` under ``nova_cycle.*``: ``cross_term2``,
``commit_t2``, ``fold2``, ``synthesize_primary``, ``pack_w1``,
``commit_w1_dispatch``, ``cross_term1``, ``commit_t1`` (which waits for
W1 and T1), ``fold_witness1``, ``synthesize_secondary`` and
``commit_w2``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List, Optional, Sequence, Tuple

from ..curves.weierstrass import CURVE_FOR_FIELD, Affine, Curve
from ..fields import FieldSpec
from ..hostlib import r1cs as hr
from ..hostlib.r1cs import PackedVec
from ..r1cs.cs import ConstraintSystem
from ..utils import metrics, tracing
from .augmented import AugmentedCfg, AugmentedWitness, synthesize_augmented
from .nova import (
    CommitmentKey, R1CSInstance, R1CSShape, RelaxedInstance,
    RelaxedWitness, _absorb_relaxed, _absorb_strict, check_relaxed,
    cross_term, fold_instance, fold_witness, z_vector,
)
from .params_cache import cached_shape
from .transcript import Transcript


def cycle_fold_challenge(curve_other: Curve, pp_digest: int,
                         acc: RelaxedInstance, new: R1CSInstance,
                         comm_t: Affine,
                         extra: Sequence[int] = ()) -> int:
    """Fold challenge for the cycle protocol (the in-circuit
    fold_relaxed_gadget recomputes this bit-exactly). `extra` binds
    per-fold context (SuperNova: the circuit index)."""
    tr = Transcript(curve_other, b"nova.fold")
    tr.absorb(pp_digest)
    for v in extra:
        tr.absorb(v)
    _absorb_relaxed(tr, acc)
    _absorb_strict(tr, new)
    tr.absorb_point(comm_t)
    return tr.squeeze()


def cycle_state_hash(curve_other: Curve, pp_digest: int, i: int,
                     z0: Sequence[int], zi: Sequence[int],
                     acc: RelaxedInstance, link: int) -> int:
    """Chain state hash (in-circuit mirror: state_hash_gadget)."""
    tr = Transcript(curve_other, b"nova.state")
    tr.absorb(pp_digest)
    tr.absorb(i)
    for v in z0:
        tr.absorb(v)
    for v in zi:
        tr.absorb(v)
    _absorb_relaxed(tr, acc)
    tr.absorb_scalar(link)
    return tr.squeeze()


def _default_relaxed() -> RelaxedInstance:
    return RelaxedInstance(None, None, [0, 0], 0)


def fold_pending(pp, proof) -> RelaxedInstance:
    """The secondary accumulator with the pending instance folded in:
    what the verifiers check and the compressions prove (``pp`` and
    ``proof`` of either cycle backend)."""
    r2 = cycle_fold_challenge(pp.curve2, pp.pp_digest, proof.u2,
                              proof.u2_pending, proof.comm_t_last)
    return fold_instance(pp.curve2, proof.u2, proof.u2_pending,
                         proof.comm_t_last, r2, pp.field2.modulus)


def _timed(name: str):
    return metrics.timed(f"nova_cycle.{name}")


# ---------------------------------------------------------------------------
# Public parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CyclePublicParams:
    field1: FieldSpec
    field2: FieldSpec
    curve1: Curve                # commits primary witnesses (order = p1)
    curve2: Curve                # commits secondary witnesses (order = p2)
    cfg1: AugmentedCfg
    cfg2: AugmentedCfg
    shape1: R1CSShape
    shape2: R1CSShape
    ck1: CommitmentKey
    ck2: CommitmentKey
    pp_digest: int
    io_arity: int

    @staticmethod
    def setup(field1: FieldSpec, io_arity: int, step_fn,
              dummy_z0: List[int], dummy_step_aux: Any, cache_base: str,
              device=None) -> "CyclePublicParams":
        """``step_fn(cs, zi_nums, aux) -> z_next``; ``dummy_step_aux``
        drives the primary shape's synthesis at the base step. The
        shapes are cached under ``cache_base``; both commitment keys
        commit on ``device``."""
        curve1 = CURVE_FOR_FIELD[field1.name]
        field2 = curve1.base
        curve2 = CURVE_FOR_FIELD[field2.name]
        if curve2.base.name != field1.name:
            raise ValueError(f"{field1.name} and {field2.name} are not a "
                             f"2-cycle")
        cfg1 = AugmentedCfg(curve_other=curve2, p_other=field2.modulus,
                            io_arity=io_arity, fold_at_base=False,
                            step_fn=step_fn)
        cfg2 = AugmentedCfg(curve_other=curve1, p_other=field1.modulus,
                            io_arity=0, fold_at_base=True)

        # shape synthesis with base-step dummies (shapes are uniform in
        # the witness by construction; pinned by tests)
        def synth1():
            w1 = AugmentedWitness(0, 0, 0, 0, list(dummy_z0),
                                  list(dummy_z0), _default_relaxed(),
                                  None, [0, 0], None, dummy_step_aux)
            cs1 = ConstraintSystem(field1)
            synthesize_augmented(cs1, cfg1, w1)
            return R1CSShape(cs1)

        def synth2():
            w2 = AugmentedWitness(0, 0, 0, 0, [], [], _default_relaxed(),
                                  None, [0, 0], None)
            cs2 = ConstraintSystem(field2)
            synthesize_augmented(cs2, cfg2, w2)
            return R1CSShape(cs2)

        with tracing.span("params.shapes", circuits=2):
            shape1 = cached_shape(f"{cache_base}_cyc1", field1, synth1)
            shape2 = cached_shape(f"{cache_base}_cyc2", field2, synth2)
        digest = hashlib.sha256(
            (shape1.digest + ":" + shape2.digest).encode()).hexdigest()
        pp_digest = int(digest, 16) & ((1 << 124) - 1)

        def _ck(curve, shape):
            n = max(shape.num_aux, shape.num_constraints, shape.num_inputs,
                    2)
            return CommitmentKey.setup(
                curve, b"lurk_tpu.ck." + curve.name.encode(),
                1 << (n - 1).bit_length(), device)

        return CyclePublicParams(
            field1, field2, curve1, curve2, cfg1, cfg2, shape1, shape2,
            _ck(curve1, shape1), _ck(curve2, shape2), pp_digest, io_arity)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CycleProof:
    """O(1) IVC proof."""

    n: int
    z0: List[int]
    zn: List[int]
    u1: RelaxedInstance          # primary accumulator (all n steps)
    w1: RelaxedWitness
    u2: RelaxedInstance          # secondary accumulator (first n-1)
    u2_pending: R1CSInstance     # last secondary instance, unfolded
    comm_t_last: Affine          # cross-term of the final fold
    w2_folded: RelaxedWitness    # witness of fold(u2, u2_pending)


class CycleSNARK:
    """Incremental prover (RecursiveSNARK::{new,prove_step} parity)."""

    def __init__(self, pp: CyclePublicParams, z0: Sequence[int]):
        self.pp = pp
        self.z0 = [v % pp.field1.modulus for v in z0]
        self.zi = list(self.z0)
        self.i = 0
        self.h = 0
        self.g = 0
        self.U1 = _default_relaxed()
        self.W1 = RelaxedWitness.default(pp.shape1)
        # the accumulator's Az1|Bz1|Cz1: z1 folds linearly, so these
        # fold forward with one RLC instead of 3 sparse matvecs a step
        self._abc1: Optional[PackedVec] = None
        self.U2 = _default_relaxed()
        self.W2 = RelaxedWitness.default(pp.shape2)
        self.pending: Optional[Tuple[R1CSInstance, PackedVec]] = None

    def prove_step(self, zi_next: Sequence[int], step_aux: Any = None,
                   check: bool = False, step_cache: Any = None) -> None:
        pp = self.pp
        p1, p2 = pp.field1.modulus, pp.field2.modulus
        zi_next = [v % p1 for v in zi_next]

        # 1. fold the pending secondary instance into U2 (host mirror of
        #    what the primary circuit verifies)
        if self.pending is None:
            if self.i != 0:
                raise ValueError("pending instance missing mid-chain")
            u2 = R1CSInstance(None, [0, 0])
            comm_t2 = None
            U2_next, W2_next = self.U2, self.W2
        else:
            u2, w2vec = self.pending
            with _timed("cross_term2"):
                t2 = cross_term(pp.shape2, self.U2, self.W2, u2.x, w2vec)
            with _timed("commit_t2"):
                comm_t2 = pp.ck2.commit(t2)
            with _timed("fold2"):
                r2 = cycle_fold_challenge(pp.curve2, pp.pp_digest,
                                          self.U2, u2, comm_t2)
                U2_next = fold_instance(pp.curve2, self.U2, u2, comm_t2,
                                        r2, p2)
                W2_next = fold_witness(p2, self.W2, w2vec, t2, r2)

        # 2. new primary chain hash
        h_next = cycle_state_hash(pp.curve2, pp.pp_digest, self.i + 1,
                                  self.z0, zi_next, U2_next, u2.x[1])

        # 3. synthesize the primary augmented circuit
        wit1 = AugmentedWitness(
            h_in=self.h, h_out=h_next, pp=pp.pp_digest, i=self.i,
            z0=self.z0, zi=self.zi, acc=self.U2, new_w=u2.comm_w,
            new_x=list(u2.x), comm_t=comm_t2, step_aux=step_aux,
            step_cache=step_cache)
        cs1 = ConstraintSystem(pp.field1, check=check,
                               witness_only=not check)
        with _timed("synthesize_primary"):
            z_next_nums = synthesize_augmented(cs1, pp.cfg1, wit1)
        if [n.value for n in z_next_nums] != zi_next:
            raise ValueError("step output does not match claimed z_next")
        if check and R1CSShape(cs1).digest != pp.shape1.digest:
            raise ValueError("primary augmented circuit shape drift")
        with _timed("pack_w1"):
            w1vec = PackedVec.pack(cs1.aux, p1)   # pack once, reuse below
        # dispatch the witness commit without waiting: the host
        # cross-term below overlaps the card's MSM
        with _timed("commit_w1_dispatch"):
            comm_w1_res = pp.ck1.commit_async(w1vec)
        u1x = cs1.inputs[1:]

        # 4. fold u1 into U1 (verified by the secondary circuit)
        shape1 = pp.shape1
        with _timed("cross_term1"):
            if self._abc1 is None:
                self._abc1 = hr.matvecs_pv(
                    shape1, z_vector(shape1, self.U1.x, self.W1.w,
                                     self.U1.u))
            z2 = z_vector(shape1, u1x, w1vec, 1)
            t1, abc2 = hr.cross_term_cached(shape1, self._abc1, self.U1.u,
                                            z2)
        with _timed("commit_t1"):
            comm_t1_res = pp.ck1.commit_async(t1)
            u1 = R1CSInstance(comm_w1_res(), u1x)
            comm_t1 = comm_t1_res()
        r1 = cycle_fold_challenge(pp.curve1, pp.pp_digest, self.U1, u1,
                                  comm_t1)
        U1_next = fold_instance(pp.curve1, self.U1, u1, comm_t1, r1, p1)
        with _timed("fold_witness1"):
            W1_next = fold_witness(p1, self.W1, w1vec, t1, r1)
            self._abc1 = hr.vec_rlc_pv(p1, self._abc1, abc2, r1)

        # 5. new secondary chain hash
        g_next = cycle_state_hash(pp.curve1, pp.pp_digest, self.i + 1,
                                  [], [], U1_next, h_next)

        # 6. synthesize the secondary augmented circuit
        wit2 = AugmentedWitness(
            h_in=self.g, h_out=g_next, pp=pp.pp_digest, i=self.i,
            z0=[], zi=[], acc=self.U1, new_w=u1.comm_w,
            new_x=list(u1.x), comm_t=comm_t1)
        cs2 = ConstraintSystem(pp.field2, check=check,
                               witness_only=not check)
        with _timed("synthesize_secondary"):
            synthesize_augmented(cs2, pp.cfg2, wit2)
        if check and R1CSShape(cs2).digest != pp.shape2.digest:
            raise ValueError("secondary augmented circuit shape drift")
        with _timed("commit_w2"):
            w2pv = PackedVec.pack(cs2.aux, p2)
            u2_new = R1CSInstance(pp.ck2.commit(w2pv), cs2.inputs[1:])
        if u2_new.x != [self.g, g_next]:
            raise ValueError("secondary instance IO does not chain")
        self.pending = (u2_new, w2pv)

        self.U1, self.W1 = U1_next, W1_next
        self.U2, self.W2 = U2_next, W2_next
        self.h, self.g = h_next, g_next
        self.zi = zi_next
        self.i += 1

    def finish(self) -> CycleProof:
        if self.i == 0 or self.pending is None:
            raise ValueError("no steps proven")
        pp = self.pp
        p2 = pp.field2.modulus
        u2, w2vec = self.pending
        with _timed("cross_term2"):
            t2 = cross_term(pp.shape2, self.U2, self.W2, u2.x, w2vec)
        with _timed("commit_t2"):
            comm_t2 = pp.ck2.commit(t2)
        with _timed("fold2"):
            r2 = cycle_fold_challenge(pp.curve2, pp.pp_digest, self.U2,
                                      u2, comm_t2)
            w2_folded = fold_witness(p2, self.W2, w2vec, t2, r2)
        return CycleProof(self.i, list(self.z0), list(self.zi),
                          self.U1, self.W1, self.U2, u2, comm_t2,
                          w2_folded)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


def chain_heads_ok(pp: CyclePublicParams, proof) -> bool:
    """The IO lengths, and the pending secondary instance's IO against
    the recomputed chain heads h_n and g_n (``proof`` a
    :class:`CycleProof` or its compressed form)."""
    if proof.n <= 0:
        return False
    if len(proof.u2_pending.x) != 2 or len(proof.u1.x) != 2 or \
            len(proof.u2.x) != 2:
        return False
    if len(proof.z0) != pp.io_arity or len(proof.zn) != pp.io_arity:
        return False
    h_n = cycle_state_hash(pp.curve2, pp.pp_digest, proof.n, proof.z0,
                           proof.zn, proof.u2, proof.u2_pending.x[0])
    g_n = cycle_state_hash(pp.curve1, pp.pp_digest, proof.n, [], [],
                           proof.u1, h_n)
    return proof.u2_pending.x[1] == g_n


def verify(pp: CyclePublicParams, proof: CycleProof) -> bool:
    """Recompute the chain heads, fold the pending secondary instance,
    and check both accumulators and their commitments (4 commits: W and
    E on each curve)."""
    if not chain_heads_ok(pp, proof):
        return False
    for shape, wit in ((pp.shape1, proof.w1), (pp.shape2, proof.w2_folded)):
        if len(wit.w) != shape.num_aux or \
                len(wit.e) != shape.num_constraints:
            return False
    u2f = fold_pending(pp, proof)
    for shape, ck, inst, wit in ((pp.shape1, pp.ck1, proof.u1, proof.w1),
                                 (pp.shape2, pp.ck2, u2f, proof.w2_folded)):
        if not check_relaxed(shape, inst, wit):
            return False
        if ck.commit(wit.w) != inst.comm_w:
            return False
        if ck.commit(wit.e) != inst.comm_e:
            return False
    return True
