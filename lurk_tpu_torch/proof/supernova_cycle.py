"""SuperNova NIVC with augmented circuits: O(#circuits) proofs.

The port of the JAX package's ``proof/supernova_cycle.py``: the host
driver of :mod:`.supernova_augmented` (reference functionality:
arecibo supernova's RecursiveSNARK, driven by reference
src/proof/supernova.rs:200-318). One running primary accumulator PER
circuit index, one uniform secondary accumulator; each step folds the
previous secondary instance in-circuit on the primary side and the
previous primary instance into the pc-selected accumulator on the
secondary side.

Both commitment keys commit on ``device`` (default ``cuda``: K6 on the
card; ``cpu``: the host Pippenger). Each step's W1 commit is dispatched
before the host cross-term and resolved after the T1 commit is
dispatched, so the card's MSM overlaps the host work; the primary
accumulator's ``Az|Bz|Cz`` is cached and folded forward with one RLC
(the JAX package's native branch; the port has no other). Each phase's
host-clock seconds go to :mod:`..utils.metrics` under
``supernova_cycle.*``: ``cross_term2``, ``commit_t2`` and ``fold2``
(together the JAX span ``cross_term2+commit`` and the secondary fold),
``synthesize_primary``, ``pack_w1``, ``commit_w1_dispatch``,
``cross_term1``, ``commit_t1`` (which waits for W1 and T1),
``fold_witness1``, ``synthesize_secondary`` and ``commit_w2``.
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
from .nova import (
    CommitmentKey, R1CSInstance, R1CSShape, RelaxedInstance,
    RelaxedWitness, _absorb_relaxed, check_relaxed, cross_term,
    fold_instance, fold_witness, z_vector,
)
from .nova_cycle import (
    _default_relaxed, cycle_fold_challenge, fold_pending,
)
from .params_cache import cached_shape
from .supernova_augmented import (
    SnPrimaryCfg, SnPrimaryWitness, SnSecondaryCfg, SnSecondaryWitness,
    synthesize_sn_primary, synthesize_sn_secondary,
)
from .transcript import Transcript


def sn_state1(curve2: Curve, pp: int, i: int, z0: Sequence[int],
              zi: Sequence[int], pc: int, acc: RelaxedInstance,
              link: int) -> int:
    tr = Transcript(curve2, b"snova.state1")
    tr.absorb(pp)
    tr.absorb(i)
    for v in z0:
        tr.absorb(v)
    for v in zi:
        tr.absorb(v)
    tr.absorb(pc)
    _absorb_relaxed(tr, acc)
    tr.absorb_scalar(link)
    return tr.squeeze()


def sn_state2(curve1: Curve, pp: int, i: int,
              accs: Sequence[RelaxedInstance], link: int) -> int:
    tr = Transcript(curve1, b"snova.state2")
    tr.absorb(pp)
    tr.absorb(i)
    for acc in accs:
        _absorb_relaxed(tr, acc)
    tr.absorb_scalar(link)
    return tr.squeeze()


def _timed(name: str):
    return metrics.timed(f"supernova_cycle.{name}")


@dataclasses.dataclass
class SnCyclePublicParams:
    field1: FieldSpec
    field2: FieldSpec
    curve1: Curve
    curve2: Curve
    cfg1s: List[SnPrimaryCfg]
    cfg2: SnSecondaryCfg
    shapes1: List[R1CSShape]
    shape2: R1CSShape
    ck1: CommitmentKey
    ck2: CommitmentKey
    pp_digest: int
    io_arity: int

    @property
    def n_circuits(self) -> int:
        return len(self.shapes1)

    @staticmethod
    def setup(field1: FieldSpec, io_arity: int, step_fns,
              dummy_z0: List[int], dummy_auxes: List[Any],
              cache_base: Optional[str] = None, device=None,
              base_allowed: bool = False) -> "SnCyclePublicParams":
        """step_fns[pc](cs, zi_nums, aux) -> (z_next, pc_next);
        dummy_auxes[pc] drives the shape synthesis of circuit pc, whose
        shapes are cached on disk under ``cache_base``, or synthesized
        and not cached when it is None. ``base_allowed`` lets a chain
        start at any circuit index. Both commitment keys commit on
        ``device``."""
        curve1 = CURVE_FOR_FIELD[field1.name]
        field2 = curve1.base
        curve2 = CURVE_FOR_FIELD[field2.name]
        if curve2.base.name != field1.name:
            raise ValueError(f"{field1.name} and {field2.name} are not a "
                             f"2-cycle")
        n = len(step_fns)
        cfg1s = [SnPrimaryCfg(curve_other=curve2, p_other=field2.modulus,
                              io_arity=io_arity, circuit_index=pc,
                              step_fn=step_fns[pc],
                              base_allowed=base_allowed)
                 for pc in range(n)]
        cfg2 = SnSecondaryCfg(curve_other=curve1,
                              p_other=field1.modulus, n_circuits=n)

        def synth1(pc):
            def go():
                w1 = SnPrimaryWitness(
                    0, 0, 0, 0 if pc == 0 else 1, list(dummy_z0),
                    list(dummy_z0), pc, _default_relaxed(), None,
                    [0, 0], None, dummy_auxes[pc])
                cs1 = ConstraintSystem(field1)
                synthesize_sn_primary(cs1, cfg1s[pc], w1)
                return R1CSShape(cs1)
            return go

        def synth2():
            w2 = SnSecondaryWitness(
                0, 0, 0, 0, 0,
                [_default_relaxed() for _ in range(n)], None, [0, 0],
                None)
            cs2 = ConstraintSystem(field2)
            synthesize_sn_secondary(cs2, cfg2, w2)
            return R1CSShape(cs2)

        with tracing.span("params.shapes", circuits=n + 1):
            if cache_base is not None:
                shapes1 = [cached_shape(f"{cache_base}_sn{pc}", field1,
                                        synth1(pc)) for pc in range(n)]
                shape2 = cached_shape(f"{cache_base}_snsec_{n}", field2,
                                      synth2)
            else:
                shapes1 = [synth1(pc)() for pc in range(n)]
                shape2 = synth2()
        h = hashlib.sha256(
            (":".join(s.digest for s in shapes1)
             + "|" + shape2.digest).encode()).hexdigest()
        pp_digest = int(h, 16) & ((1 << 124) - 1)

        def _ck(curve, n_max):
            size = 1 << (max(n_max, 2) - 1).bit_length()
            return CommitmentKey.setup(
                curve, b"lurk_tpu.ck." + curve.name.encode(), size, device)

        n1 = max(max(s.num_aux, s.num_constraints) for s in shapes1)
        n2 = max(shape2.num_aux, shape2.num_constraints)
        return SnCyclePublicParams(
            field1, field2, curve1, curve2, cfg1s, cfg2, shapes1,
            shape2, _ck(curve1, n1), _ck(curve2, n2), pp_digest,
            io_arity)


@dataclasses.dataclass
class SnCycleProof:
    """O(#circuits) NIVC proof."""

    n: int
    z0: List[int]
    zn: List[int]
    pc_n: int                     # pc the (n+1)-th step would run
    u1s: List[RelaxedInstance]    # per-circuit primary accumulators
    w1s: List[RelaxedWitness]
    u2: RelaxedInstance
    u2_pending: R1CSInstance
    comm_t_last: Affine
    w2_folded: RelaxedWitness


class SnCycleSNARK:
    """Incremental NIVC prover (supernova RecursiveSNARK parity)."""

    def __init__(self, pp: SnCyclePublicParams, z0: Sequence[int],
                 initial_pc: int = 0):
        self.pp = pp
        self.z0 = [v % pp.field1.modulus for v in z0]
        self.zi = list(self.z0)
        self.i = 0
        self.pc = initial_pc           # pc of the NEXT step to prove
        self.h = 0
        self.g = 0
        self.U1 = [_default_relaxed() for _ in range(pp.n_circuits)]
        self.W1 = [RelaxedWitness.default(s) for s in pp.shapes1]
        # cached accumulator matvecs (Az1|Bz1|Cz1) per circuit: z1
        # folds linearly, so these fold forward with one RLC instead
        # of 3 sparse matvecs per cross-term
        self._abc1: List[Optional[PackedVec]] = [None] * pp.n_circuits
        self.U2 = _default_relaxed()
        self.W2 = RelaxedWitness.default(pp.shape2)
        self.pending: Optional[Tuple[R1CSInstance, PackedVec]] = None

    def prove_step(self, pc: int, zi_next: Sequence[int], pc_next: int,
                   step_aux: Any = None, check: bool = False,
                   step_cache: Any = None) -> None:
        pp = self.pp
        if pc != self.pc:
            raise ValueError(f"expected circuit {self.pc}, got {pc}")
        p1, p2 = pp.field1.modulus, pp.field2.modulus
        zi_next = [v % p1 for v in zi_next]

        # 1. fold the pending secondary instance into U2 (host mirror)
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

        # 2. new primary chain hash (binds pc_next)
        h_next = sn_state1(pp.curve2, pp.pp_digest, self.i + 1, self.z0,
                           zi_next, pc_next, U2_next, u2.x[1])

        # 3. synthesize the primary augmented circuit for `pc`
        wit1 = SnPrimaryWitness(
            h_in=self.h, h_out=h_next, pp=pp.pp_digest, i=self.i,
            z0=self.z0, zi=self.zi, pc_in=pc, acc=self.U2,
            new_w=u2.comm_w, new_x=list(u2.x), comm_t=comm_t2,
            step_aux=step_aux, step_cache=step_cache)
        cs1 = ConstraintSystem(pp.field1, check=check,
                               witness_only=not check)
        with _timed("synthesize_primary"):
            z_next_nums, pc_next_num = synthesize_sn_primary(
                cs1, pp.cfg1s[pc], wit1)
        if [n.value for n in z_next_nums] != zi_next:
            raise ValueError("step output does not match claimed z_next")
        if pc_next_num.value != pc_next % p1:
            raise ValueError("step's next circuit does not match pc_next")
        if check and R1CSShape(cs1).digest != pp.shapes1[pc].digest:
            raise ValueError(f"primary circuit {pc} shape drift")
        with _timed("pack_w1"):
            w1vec = PackedVec.pack(cs1.aux, p1)   # pack once, reuse below
        # dispatch the witness commit without waiting: the host
        # cross-term below overlaps the card's MSM
        with _timed("commit_w1_dispatch"):
            comm_w1_res = pp.ck1.commit_async(w1vec)
        u1x = cs1.inputs[1:]

        # 4. fold u1 into U1[pc] (challenge binds pc)
        shape1 = pp.shapes1[pc]
        with _timed("cross_term1"):
            if self._abc1[pc] is None:
                # init from the CURRENT accumulator (nonzero after a
                # resume)
                self._abc1[pc] = hr.matvecs_pv(
                    shape1, z_vector(shape1, self.U1[pc].x,
                                     self.W1[pc].w, self.U1[pc].u))
            z2 = z_vector(shape1, u1x, w1vec, 1)
            t1, abc2 = hr.cross_term_cached(shape1, self._abc1[pc],
                                            self.U1[pc].u, z2)
        with _timed("commit_t1"):
            comm_t1_res = pp.ck1.commit_async(t1)
            u1 = R1CSInstance(comm_w1_res(), u1x)
            comm_t1 = comm_t1_res()
        r1 = cycle_fold_challenge(pp.curve1, pp.pp_digest, self.U1[pc],
                                  u1, comm_t1, extra=(pc,))
        U1_next = list(self.U1)
        W1_next = list(self.W1)
        U1_next[pc] = fold_instance(pp.curve1, self.U1[pc], u1, comm_t1,
                                    r1, p1)
        with _timed("fold_witness1"):
            W1_next[pc] = fold_witness(p1, self.W1[pc], w1vec, t1, r1)
            self._abc1[pc] = hr.vec_rlc_pv(p1, self._abc1[pc], abc2, r1)

        # 5. new secondary chain hash over the accumulator LIST
        g_next = sn_state2(pp.curve1, pp.pp_digest, self.i + 1, U1_next,
                           h_next)

        # 6. synthesize the secondary circuit
        wit2 = SnSecondaryWitness(
            g_in=self.g, g_out=g_next, pp=pp.pp_digest, i=self.i,
            pc=pc, accs=list(self.U1), new_w=u1.comm_w,
            new_x=list(u1.x), comm_t=comm_t1)
        cs2 = ConstraintSystem(pp.field2, check=check,
                               witness_only=not check)
        with _timed("synthesize_secondary"):
            synthesize_sn_secondary(cs2, pp.cfg2, wit2)
        if check and R1CSShape(cs2).digest != pp.shape2.digest:
            raise ValueError("secondary circuit shape drift")
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
        self.pc = pc_next
        self.i += 1

    def finish(self) -> SnCycleProof:
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
        return SnCycleProof(self.i, list(self.z0), list(self.zi),
                            self.pc, list(self.U1), list(self.W1),
                            self.U2, u2, comm_t2, w2_folded)


def verify(pp: SnCyclePublicParams, proof: SnCycleProof) -> bool:
    """Recompute the chain heads, fold the pending secondary instance,
    and check every accumulator and its commitments (4 commits: W and E
    on each curve, one circuit)."""
    if proof.n <= 0:
        return False
    if len(proof.u1s) != pp.n_circuits or len(proof.w1s) != pp.n_circuits:
        return False
    if len(proof.u2_pending.x) != 2 or len(proof.u2.x) != 2 or \
            any(len(u.x) != 2 for u in proof.u1s):
        return False
    if len(proof.z0) != pp.io_arity or len(proof.zn) != pp.io_arity:
        return False
    for shape, wit in [*zip(pp.shapes1, proof.w1s),
                       (pp.shape2, proof.w2_folded)]:
        if len(wit.w) != shape.num_aux or \
                len(wit.e) != shape.num_constraints:
            return False
    h_n = sn_state1(pp.curve2, pp.pp_digest, proof.n, proof.z0,
                    proof.zn, proof.pc_n, proof.u2,
                    proof.u2_pending.x[0])
    g_n = sn_state2(pp.curve1, pp.pp_digest, proof.n, proof.u1s, h_n)
    if proof.u2_pending.x[1] != g_n:
        return False
    u2f = fold_pending(pp, proof)
    for pc in range(pp.n_circuits):
        if not check_relaxed(pp.shapes1[pc], proof.u1s[pc],
                             proof.w1s[pc]):
            return False
        if pp.ck1.commit(proof.w1s[pc].w) != proof.u1s[pc].comm_w:
            return False
        if pp.ck1.commit(proof.w1s[pc].e) != proof.u1s[pc].comm_e:
            return False
    if not check_relaxed(pp.shape2, u2f, proof.w2_folded):
        return False
    if pp.ck2.commit(proof.w2_folded.w) != u2f.comm_w:
        return False
    return pp.ck2.commit(proof.w2_folded.e) == u2f.comm_e
