"""MemoSet NIVC circuits: CircuitScope / CircuitQuery / CoroutineCircuit.

The port of the JAX package's ``coroutine/circuit.py`` (reference
functionality: src/coroutine/memoset/mod.rs:421-1320 and query.rs).
Each NIVC step circuit proves up to ``rc`` memoized queries of ONE
query index:

    z = [c, e, k, memoset_acc, transcript, r]        (6 ptrs, 12 scalars)

Per key: the query's own circuit evaluates the result (its internal
queries each INSERT their advice provenance into the LogUp accumulator
with weight 1/(r + H(prov))), the key's provenance, built in the
circuit, is REMOVED with its use-count multiplicity, and the removal is
appended to the in-circuit transcript. The verifier checks the final z:
acc == 0 (multiset balance) and transcript digest == r (Fiat-Shamir
binding).

Soundness note, as in the JAX package: unlike the reference (which
leaves ``_query`` unused when deconstructing a use-site provenance,
mod.rs:1150), internal queries here also enforce provenance.query ==
the subquery key built in the circuit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..coproc.gadgets import construct_cons, hash_nums
from ..lem.circuit import (
    AllocatedPtr, Synthesizer, SynthesisCtx, alloc_ptr,
)
from ..r1cs.cs import ConstraintSystem
from ..r1cs.gadgets import (
    Bool, Num, add, alloc_bit, alloc_input_num, alloc_is_zero, alloc_num,
    bool_and, enforce_equal, implies_equal, mul, pick, sub,
)
from ..store.core import Ptr, Store
from ..symbol import Symbol
from ..tags import ExprTag
from .memoset import Provenance, Scope


def _synth(cs: ConstraintSystem, store: Store) -> Synthesizer:
    return Synthesizer(SynthesisCtx(cs, store, {}, False, {}, {}))


def pick_ptr(cs: ConstraintSystem, cond: Bool, a: AllocatedPtr,
             b: AllocatedPtr) -> AllocatedPtr:
    return AllocatedPtr(pick(cs, cond, a.tag, b.tag),
                        pick(cs, cond, a.hash, b.hash))


class CircuitScope:
    """In-circuit LogUp bookkeeping for one CoroutineCircuit step."""

    def __init__(self, synth: Synthesizer, scope: Scope, r: Num,
                 acc: AllocatedPtr, transcript: AllocatedPtr):
        self.synth = synth
        self.cs = synth.cs
        self.store = synth.store
        self.scope = scope
        self.provenances: Dict[Ptr, Ptr] = scope._provenances
        self.counts: Dict[Ptr, int] = scope._removal_counts
        self.r = r
        self.acc = acc
        self.transcript = transcript

    # -- LogMemo -------------------------------------------------------------

    def map_to_element(self, x: Num) -> Num:
        """1/(r + x): advice inverse + (r+x)*inv = 1 (LogMemo
        synthesize_map_to_element)."""
        cs = self.cs
        denom = add(cs, self.r, x)
        inv_val = pow(denom.value, cs.p - 2, cs.p) if denom.value else 0
        inv = alloc_num(cs, inv_val)
        prod = mul(cs, denom, inv)
        enforce_equal(cs, prod, Num.constant(cs, 1))
        return inv

    def acc_add(self, acc: AllocatedPtr, prov: AllocatedPtr
                ) -> AllocatedPtr:
        el = self.map_to_element(prov.hash)
        return AllocatedPtr(Num.constant(self.cs, int(ExprTag.Num)),
                            add(self.cs, acc.hash, el))

    def acc_remove_n(self, acc: AllocatedPtr, prov: AllocatedPtr,
                     count: Num) -> AllocatedPtr:
        el = self.map_to_element(prov.hash)
        scaled = mul(self.cs, el, count)
        return AllocatedPtr(Num.constant(self.cs, int(ExprTag.Num)),
                            sub(self.cs, acc.hash, scaled))

    # -- queries -------------------------------------------------------------

    def dummy_provenance_ptr(self) -> Ptr:
        return Provenance.dummy(self.store).to_ptr(self.store)

    def synthesize_internal_query(self, key: AllocatedPtr,
                                  key_ptr: Optional[Ptr],
                                  acc: AllocatedPtr, not_dummy: Bool
                                  ) -> Tuple[AllocatedPtr, AllocatedPtr,
                                             AllocatedPtr]:
        """(result, provenance, new_acc): allocate the sub-provenance as
        advice, bind it to ``key``, insert it into the accumulator."""
        cs, s = self.cs, self.store
        prov_ptr = None
        if key_ptr is not None:
            prov_ptr = self.provenances.get(key_ptr)
        if prov_ptr is None:
            prov_ptr = self.dummy_provenance_ptr()
        zp = s.hash_ptr(prov_ptr)
        prov = alloc_ptr(cs, int(ExprTag.Prov), zp.digest)
        # advice children + re-hash binding (deconstruct_provenance)
        q_ptr, res_ptr, deps_ptr = s.fetch_compact(prov_ptr)
        q_hash = alloc_num(cs, s.hash_ptr(q_ptr).digest)
        res_z = s.hash_ptr(res_ptr)
        res = alloc_ptr(cs, res_z.tag, res_z.digest)
        deps_hash = alloc_num(cs, s.hash_ptr(deps_ptr).digest)
        digest = hash_nums(self.synth, [q_hash, res.tag, res.hash,
                                        deps_hash])
        implies_equal(cs, not_dummy, prov.hash, digest)
        # bind the provenance to THIS subquery (see module docstring)
        implies_equal(cs, not_dummy, q_hash, key.hash)
        new_acc = self.acc_add(acc, prov)
        return res, prov, new_acc

    def synthesize_remove(self, acc: AllocatedPtr,
                          transcript: AllocatedPtr, key: AllocatedPtr,
                          key_ptr: Optional[Ptr], val: AllocatedPtr,
                          prov: AllocatedPtr, not_dummy: Bool
                          ) -> Tuple[AllocatedPtr, AllocatedPtr]:
        cs = self.cs
        raw_count = 0
        if not_dummy.value and key_ptr is not None:
            raw_count = self.counts.get(key_ptr, 0)
        dummy_prov = self.synth.const_for_ptr(self.dummy_provenance_ptr())
        eff_prov = pick_ptr(cs, not_dummy, prov, dummy_prov)
        count = alloc_num(cs, raw_count)
        count_ptr = AllocatedPtr(
            Num.constant(cs, int(ExprTag.Num)), count)
        prov_count = construct_cons(self.synth, eff_prov, count_ptr)
        new_transcript = construct_cons(self.synth, prov_count,
                                        transcript)
        new_acc = self.acc_remove_n(acc, prov, count)
        return new_acc, new_transcript


class CircuitQuery:
    """Per-query-type circuit evaluator. Subclasses synthesize the
    query's computation (internal queries through the scope) with a
    SHAPE THAT DOES NOT DEPEND ON THE WITNESS (folding uniformity)."""

    def symbol(self) -> Symbol:
        raise NotImplementedError

    def for_index(self, index: int) -> "CircuitQuery":
        """Specialize to one NIVC circuit index (multi-coroutine
        toplevels override; single-query types are index-free)."""
        return self

    def circuits_key(self) -> tuple:
        """What the in-memory cache of public parameters keys this
        query's circuits by: its class, for a query with no state."""
        return (type(self).__module__, type(self).__qualname__)

    def synthesize_eval(self, scope: CircuitScope, key: AllocatedPtr,
                        key_ptr: Optional[Ptr], acc: AllocatedPtr,
                        not_dummy: Bool
                        ) -> Tuple[AllocatedPtr, AllocatedPtr,
                                   AllocatedPtr]:
        """(value, provenance, new_acc)."""
        raise NotImplementedError

    def synthesize_provenance(self, scope: CircuitScope,
                              key: AllocatedPtr, value: AllocatedPtr,
                              dep_provs: List[AllocatedPtr]
                              ) -> AllocatedPtr:
        """Construct the provenance IN-CIRCUIT: hash4(key_digest,
        val.tag, val.hash, deps_digest) with deps = single | list | nil
        (the memoset.Provenance.to_ptr convention)."""
        synth, cs, s = scope.synth, scope.cs, scope.store
        if len(dep_provs) == 1:
            deps_hash = dep_provs[0].hash
        elif not dep_provs:
            deps_hash = synth.const_for_ptr(s.intern_nil()).hash
        else:
            lst = synth.const_for_ptr(s.intern_nil())
            for dep in reversed(dep_provs):
                lst = construct_cons(synth, dep, lst)
            deps_hash = lst.hash
        digest = hash_nums(synth, [key.hash, value.tag, value.hash,
                                   deps_hash])
        return AllocatedPtr(Num.constant(cs, int(ExprTag.Prov)), digest)


class DemoCircuitQuery(CircuitQuery):
    """In-circuit factorial (memoset/demo.rs): the canonical recursive
    memoized query."""

    SYMBOL = Symbol(("lurk", "user", "factorial"), False)

    def symbol(self) -> Symbol:
        return self.SYMBOL

    def synthesize_eval(self, scope: CircuitScope, key: AllocatedPtr,
                        key_ptr: Optional[Ptr], acc: AllocatedPtr,
                        not_dummy: Bool):
        synth, cs, s = scope.synth, scope.cs, scope.store
        # advice: key = (factorial n) -> n; a dummy uses n = 0
        n_val = 0
        if key_ptr is not None:
            lst = s.fetch_proper_list(key_ptr)
            if lst and len(lst) == 2:
                n_val = s.fetch_num(lst[1]) or 0
        n = alloc_num(cs, n_val)
        n_ptr = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)), n)
        # bind n to the key: key == (factorial n) as hashes
        sym = synth.const_for_ptr(s.intern_symbol(self.SYMBOL))
        nil = synth.const_for_ptr(s.intern_nil())
        rest = construct_cons(synth, n_ptr, nil)
        rebuilt = construct_cons(synth, sym, rest)
        implies_equal(cs, not_dummy, rebuilt.hash, key.hash)

        n_is_zero = alloc_is_zero(cs, n)
        is_recursive = n_is_zero.not_()
        base_case = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)),
                                 Num.constant(cs, 1))
        # subquery key (factorial (n-1)) built in the circuit
        new_n = sub(cs, n, Num.constant(cs, 1))
        new_n_ptr = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)),
                                 new_n)
        sub_rest = construct_cons(synth, new_n_ptr, nil)
        subkey = construct_cons(synth, sym, sub_rest)
        sub_key_ptr = None
        if key_ptr is not None and n_val != 0:
            sub_key_ptr = s.cons(
                s.intern_symbol(self.SYMBOL),
                s.cons(s.num(n_val - 1), s.intern_nil()))
        sub_not_dummy = bool_and(cs, not_dummy, is_recursive)
        sub_res, sub_prov, acc_after = scope.synthesize_internal_query(
            subkey, sub_key_ptr, acc, sub_not_dummy)
        # recursive result: n * sub
        rec_val = mul(cs, n, sub_res.hash)
        recursive = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)),
                                 rec_val)
        value = pick_ptr(cs, is_recursive, recursive, base_case)
        new_acc = pick_ptr(cs, is_recursive, acc_after, acc)
        # deps convention: the single dep when recursive, nil at the
        # base; Provenance.to_ptr stores a 1-element dep list as the dep
        eff_dep = pick_ptr(cs, is_recursive, sub_prov,
                           synth.const_for_ptr(s.intern_nil()))
        prov = self.synthesize_provenance(scope, key, value, [eff_dep])
        return value, prov, new_acc


@dataclasses.dataclass
class CoroutineCircuit:
    """One NIVC step: up to rc queries of one index
    (mod.rs:432-558 CoroutineCircuit::supernova_synthesize)."""

    scope: Scope
    keys: List[Optional[Ptr]]
    index: int
    rc: int
    circuit_query: CircuitQuery

    def synthesize(self, cs: ConstraintSystem, z_in: List[int],
                   z_out: List[int]) -> None:
        z_in_nums = [alloc_input_num(cs, v) for v in z_in]
        z_out_nums = [alloc_input_num(cs, v) for v in z_out]
        ptrs = [AllocatedPtr(z_in_nums[2 * i], z_in_nums[2 * i + 1])
                for i in range(6)]
        outs = self.synthesize_with_inputs(cs, ptrs)
        for i, ptr in enumerate(outs):
            enforce_equal(cs, ptr.tag, z_out_nums[2 * i])
            enforce_equal(cs, ptr.hash, z_out_nums[2 * i + 1])

    def synthesize_with_inputs(self, cs: ConstraintSystem,
                               ptrs: List[AllocatedPtr]
                               ) -> List[AllocatedPtr]:
        """The step over pre-allocated z pointers (also the step
        function of the cycle prover, :mod:`.prove_cycle`)."""
        s = self.scope.store
        synth = _synth(cs, s)
        c, e, k, acc, transcript, r_ptr = ptrs
        scope_c = CircuitScope(synth, self.scope, r_ptr.hash, acc,
                               transcript)
        keys = list(self.keys) + [None] * (self.rc - len(self.keys))
        for key_ptr in keys:
            not_dummy = alloc_bit(cs, key_ptr is not None)
            zk = s.hash_ptr(key_ptr if key_ptr is not None
                            else s.intern_nil())
            key = alloc_ptr(cs, zk.tag, zk.digest)
            val, prov, new_acc = self.circuit_query.synthesize_eval(
                scope_c, key, key_ptr, scope_c.acc, not_dummy)
            new_acc, new_transcript = scope_c.synthesize_remove(
                new_acc, scope_c.transcript, key, key_ptr, val, prov,
                not_dummy)
            scope_c.acc = pick_ptr(cs, not_dummy, new_acc, scope_c.acc)
            scope_c.transcript = new_transcript
        return [c, e, k, scope_c.acc, scope_c.transcript, r_ptr]

    def instance(self, z_in: List[int], z_out: List[int],
                 shape_check: bool = False):
        cs = ConstraintSystem(self.scope.store.field, check=shape_check)
        self.synthesize(cs, z_in, z_out)
        return cs.inputs[1:], list(cs.aux), cs
