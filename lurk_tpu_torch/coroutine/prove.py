"""MemosetProver: NIVC folding over CoroutineCircuit steps.

The port of the JAX package's ``coroutine/prove.py`` (reference
functionality: src/coroutine/memoset/prove.rs): each chunk of up to
``rc`` unique keys of one query index becomes one NIVC step (circuit
index = query index); the z vector is 6 pointers (12 scalars):

    z0 = [dummy, dummy, dummy, init_memoset, init_transcript, (Cons, r)]

and the verifier accepts iff the fold chains and the IO linkage hold AND
the final z shows a balanced LogUp accumulator (acc == Num 0) with the
transcript digest equal to the Fiat-Shamir r it was folded under.

The JAX package's ``MemosetPublicParams`` and ``MemosetProof`` are the
NIVC backend's (:class:`..proof.supernova.SuperNovaPublicParams`,
:class:`..proof.supernova.NivcProof`: the same fields, key and
labels), and each index's fold is a :class:`..proof.nova.RecursiveSNARK`
over its view of them, so the key commits on the prover's ``device``
(default ``cuda``: every W, T and E commit of 64 scalars or more
through K6). Where the JAX package asserts, the port raises:
``ValueError`` on the caller's input, ``SynthesisError`` on a step that
is not uniform or not satisfied.
"""

from __future__ import annotations

from typing import List, Tuple

from ..proof import supernova as sn
from ..proof.nova import R1CSShape, RecursiveSNARK, check_strict
from ..r1cs.cs import SynthesisError
from ..store.core import Ptr
from ..tags import ExprTag
from .circuit import CircuitQuery, CoroutineCircuit
from .memoset import Provenance, Scope, Transcript

COROUTINE_ARITY = 12    # 6 tagged pointers

MemosetPublicParams = sn.SuperNovaPublicParams
MemosetProof = sn.NivcProof


class MemosetProver:
    """Prove a finalized Scope's query set (prove.rs:209-241), the key
    on ``device``."""

    def __init__(self, rc: int, circuit_query: CircuitQuery,
                 check_steps: bool = False, device=None):
        self.rc = rc
        self.circuit_query = circuit_query
        self.check_steps = check_steps
        self.device = device

    def z0(self, scope: Scope) -> List[int]:
        s = scope.store
        dummy = s.hash_ptr(s.intern_nil())
        tr0 = s.hash_ptr(scope.init_transcript_ptr())
        return [
            dummy.tag, dummy.digest, dummy.tag, dummy.digest,
            dummy.tag, dummy.digest,
            int(ExprTag.Num), scope.init_memoset(),
            tr0.tag, tr0.digest,
            int(ExprTag.Cons), scope.r,
        ]

    def steps(self, scope: Scope) -> List[CoroutineCircuit]:
        """The step circuits: per index, in order, chunks of rc unique
        keys (the scope finalized and its store hydrated first)."""
        if scope.default_rc != self.rc:
            raise ValueError(
                "scope rc must match prover rc (transcript padding)")
        if scope.transcript is None:
            scope.finalize_transcript()
        scope.store.hydrate_z_cache()
        steps: List[CoroutineCircuit] = []
        for index in sorted(scope.unique_inserted_keys):
            keys = scope.unique_inserted_keys[index]
            cq = self.circuit_query.for_index(index)
            for start in range(0, len(keys), self.rc):
                steps.append(CoroutineCircuit(
                    scope, keys[start:start + self.rc], index, self.rc,
                    cq))
        return steps

    def next_z(self, scope: Scope, step: CoroutineCircuit, z: List[int],
               tr_ptr: Ptr) -> Tuple[List[int], Ptr]:
        """The step's z_out and transcript, computed on the host as the
        circuit updates them, one key slot at a time."""
        s = scope.store
        p = s.field.modulus
        r = scope.r

        def elem(prov: Ptr) -> int:
            x = s.hash_ptr(prov).digest
            return pow((r + x) % p, p - 2, p)

        acc = z[7]
        for i in range(step.rc):
            key = step.keys[i] if i < len(step.keys) else None
            if key is not None:
                prov = scope._provenances[key]
                count = scope._removal_counts.get(key, 0)
                # dependency insertions of this key's proven eval
                for dep in scope.dependencies.get(key, []):
                    acc = (acc + elem(
                        scope._provenances[dep.to_ptr(s)])) % p
                acc = (acc - count * elem(prov)) % p
            else:
                prov = Provenance.dummy(s).to_ptr(s)
                count = 0
            pc_ptr = Transcript.make_provenance_count(s, prov, count)
            tr_ptr = s.cons(pc_ptr, tr_ptr)
        s.hydrate_z_cache()
        z_out = list(z)
        z_out[7] = acc
        z_out[8] = s.hash_ptr(tr_ptr).tag
        z_out[9] = s.hash_ptr(tr_ptr).digest
        return z_out, tr_ptr

    def prove_from_scope(self, scope: Scope
                         ) -> Tuple[MemosetPublicParams, MemosetProof]:
        steps = self.steps(scope)
        z = self.z0(scope)
        tr_ptr = scope.init_transcript_ptr()
        shapes = {}
        instances = []
        for step in steps:
            z_out, tr_ptr = self.next_z(scope, step, z, tr_ptr)
            x, w, cs = step.instance(z, z_out,
                                     shape_check=self.check_steps)
            shape = R1CSShape(cs)
            if step.index not in shapes:
                shapes[step.index] = shape
            elif shapes[step.index].digest != shape.digest:
                raise SynthesisError("non-uniform coroutine circuit")
            instances.append((step.index, x, w))
            z = z_out
        pp = MemosetPublicParams.setup(shapes, self.device)
        snarks = {i: RecursiveSNARK(pp.params_for(i)) for i in shapes}
        proof_steps = []
        for idx, x, w in instances:
            if self.check_steps and not check_strict(shapes[idx], x, w):
                raise SynthesisError("unsat coroutine step")
            rs = snarks[idx]
            rs.prove_step(x, w)
            inst, comm_t = rs.steps[-1]
            proof_steps.append((idx, inst, comm_t))
        return pp, MemosetProof(
            proof_steps, {i: rs.acc_wit for i, rs in snarks.items()},
            self.z0(scope), z)


def final_state_ok(z0: List[int], zn: List[int]) -> bool:
    """The memoset's final state: a balanced multiset (acc == (Num, 0))
    and the Fiat-Shamir binding (transcript digest == r, on which z0
    agrees)."""
    if zn[6] != int(ExprTag.Num) or zn[7] != 0:
        return False
    if zn[10] != int(ExprTag.Cons) or zn[11] != zn[9]:
        return False
    return z0[10] == int(ExprTag.Cons) and z0[11] == zn[11]


def verify(pp: MemosetPublicParams, proof: MemosetProof) -> bool:
    """Fold chains + IO linkage + the memoset's final-state checks."""
    if len(proof.z0) != COROUTINE_ARITY or \
            len(proof.zi) != COROUTINE_ARITY:
        return False
    return final_state_ok(proof.z0, proof.zi) and sn.verify(pp, proof)
