"""Reusable allocation gadgets for coprocessor circuits.

The port of the JAX package's ``coproc/gadgets.py`` (reference
src/coprocessor/gadgets.rs:23-728): helpers a
CoCircuit author uses to build/deconstruct Lurk data in-circuit:
construct_cons / construct_list / construct_env / construct_provenance,
deconstruct_tuple2/3/4, car_cdr (string-aware semantics of the Car/Cdr
path is the caller's concern here; this module exposes the hash-level
building blocks).

Unlike the LEM compiler's slot machinery (shared Poseidon instances),
these gadgets synthesize DEDICATED Poseidon instances, as in the
reference, where coprocessor gadgets hash outside the slot system (on a
witness-only system, the witness trace of
:func:`..poseidon.circuit.poseidon_witness`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..lem.circuit import AllocatedPtr, Synthesizer, alloc_ptr
from ..poseidon.circuit import poseidon_circuit, poseidon_witness
from ..r1cs.gadgets import Bool, Num, add, alloc_equal, bool_and, \
    implies_equal, pick
from ..store.core import Ptr
from ..tags import ExprTag


def hash_nums(synth: Synthesizer, preimage: Sequence[Num]) -> Num:
    """Dedicated Poseidon instance over `len(preimage)` field elements."""
    if synth.cs.witness_only:
        return poseidon_witness(synth.cs, synth.store.field,
                                list(preimage))
    return poseidon_circuit(synth.cs, synth.store.field, list(preimage))


def construct_tuple2(synth: Synthesizer, tag: int, a: AllocatedPtr,
                     b: AllocatedPtr) -> AllocatedPtr:
    digest = hash_nums(synth, [a.tag, a.hash, b.tag, b.hash])
    return AllocatedPtr(Num.constant(synth.cs, int(tag)), digest)


def construct_cons(synth: Synthesizer, car: AllocatedPtr,
                   cdr: AllocatedPtr) -> AllocatedPtr:
    return construct_tuple2(synth, ExprTag.Cons, car, cdr)


def construct_tuple3(synth: Synthesizer, tag: int, a: AllocatedPtr,
                     b: AllocatedPtr, c: AllocatedPtr) -> AllocatedPtr:
    digest = hash_nums(
        synth, [a.tag, a.hash, b.tag, b.hash, c.tag, c.hash])
    return AllocatedPtr(Num.constant(synth.cs, int(tag)), digest)


def construct_tuple4(synth: Synthesizer, tag: int, a: AllocatedPtr,
                     b: AllocatedPtr, c: AllocatedPtr,
                     d: AllocatedPtr) -> AllocatedPtr:
    digest = hash_nums(synth, [a.tag, a.hash, b.tag, b.hash, c.tag,
                               c.hash, d.tag, d.hash])
    return AllocatedPtr(Num.constant(synth.cs, int(tag)), digest)


def construct_env(synth: Synthesizer, sym_hash: Num, val: AllocatedPtr,
                  rest_env_hash: Num) -> AllocatedPtr:
    """Env compact hashing: hash4([sym_digest, val.tag, val.digest,
    env_digest]) (store.rs hasher parity)."""
    digest = hash_nums(synth, [sym_hash, val.tag, val.hash,
                               rest_env_hash])
    return AllocatedPtr(Num.constant(synth.cs, int(ExprTag.Env)), digest)


def construct_provenance(synth: Synthesizer, query_hash: Num,
                         result: AllocatedPtr,
                         deps_hash: Num) -> AllocatedPtr:
    digest = hash_nums(synth, [query_hash, result.tag, result.hash,
                               deps_hash])
    return AllocatedPtr(Num.constant(synth.cs, int(ExprTag.Prov)), digest)


def construct_list(synth: Synthesizer, elts: Sequence[AllocatedPtr],
                   last: Optional[AllocatedPtr] = None) -> AllocatedPtr:
    store = synth.store
    if last is None:
        acc = synth.const_for_ptr(store.intern_nil())
    else:
        acc = last
    for elt in reversed(list(elts)):
        acc = construct_cons(synth, elt, acc)
    return acc


def _advice_ptr(synth: Synthesizer, ptr) -> AllocatedPtr:
    z = synth.store.hash_ptr(ptr)
    return alloc_ptr(synth.cs, z.tag, z.digest)


def deconstruct_tuple2(synth: Synthesizer, not_dummy: Bool,
                       img: AllocatedPtr, children) -> Tuple[AllocatedPtr,
                                                             AllocatedPtr]:
    """Allocate children (advice), re-hash, and enforce (under
    not_dummy) that the hash equals img's digest."""
    a = _advice_ptr(synth, children[0])
    b = _advice_ptr(synth, children[1])
    digest = hash_nums(synth, [a.tag, a.hash, b.tag, b.hash])
    implies_equal(synth.cs, not_dummy, img.hash, digest)
    return a, b


def deconstruct_tuple3(synth: Synthesizer, not_dummy: Bool,
                       img: AllocatedPtr, children
                       ) -> Tuple[AllocatedPtr, AllocatedPtr,
                                  AllocatedPtr]:
    """gadgets.rs:368-414 deconstruct_tuple3: hash6 re-hash of the
    three advice children, enforced under not_dummy."""
    ptrs = [_advice_ptr(synth, c) for c in children]
    pre: List[Num] = []
    for p in ptrs:
        pre.extend((p.tag, p.hash))
    digest = hash_nums(synth, pre)
    implies_equal(synth.cs, not_dummy, img.hash, digest)
    return tuple(ptrs)


def deconstruct_tuple4(synth: Synthesizer, not_dummy: Bool,
                       img: AllocatedPtr, children):
    ptrs = [_advice_ptr(synth, c) for c in children]
    pre: List[Num] = []
    for p in ptrs:
        pre.extend((p.tag, p.hash))
    digest = hash_nums(synth, pre)
    implies_equal(synth.cs, not_dummy, img.hash, digest)
    return tuple(ptrs)


# ---------------------------------------------------------------------------
# car_cdr family (gadgets.rs:464-831)
# ---------------------------------------------------------------------------


def _ptrs_equal(synth: Synthesizer, a: AllocatedPtr,
                b: AllocatedPtr) -> Bool:
    cs = synth.cs
    return bool_and(cs, alloc_equal(cs, a.tag, b.tag),
                    alloc_equal(cs, a.hash, b.hash))


def _enforce_car_cdr_nil(synth: Synthesizer, not_dummy: Bool,
                         data_is_nil: Bool, nil: AllocatedPtr,
                         car: AllocatedPtr, cdr: AllocatedPtr) -> None:
    """gadgets.rs:577-595: nil data forces car = cdr = nil."""
    cs = synth.cs
    premise = bool_and(cs, not_dummy, data_is_nil)
    car.implies_ptr_equal(cs, premise, nil)
    cdr.implies_ptr_equal(cs, premise, nil)


def car_cdr(synth: Synthesizer, not_dummy: Bool, data: AllocatedPtr,
            data_ptr: Optional[Ptr]
            ) -> Tuple[AllocatedPtr, AllocatedPtr, Bool]:
    """String-aware car_cdr (gadgets.rs:583-658): returns (car, cdr,
    data_is_not_empty). `data_ptr` is the concrete pointer behind
    `data` (advice; None when dummy). Cases enforced in-circuit:
    nil -> (nil, nil); "" -> (nil, ""); otherwise hash4([car, cdr])
    must equal data's digest."""
    cs = synth.cs
    store = synth.store
    if data_ptr is not None:
        car_p, cdr_p = store.car_cdr(data_ptr)
        car = _advice_ptr(synth, car_p)
        cdr = _advice_ptr(synth, cdr_p)
    else:
        car = alloc_ptr(cs, 0, 0)
        cdr = alloc_ptr(cs, 0, 0)
    nil = synth.const_for_ptr(store.intern_nil())
    empty_str = synth.const_for_ptr(store.intern_string(""))
    data_is_nil = _ptrs_equal(synth, data, nil)
    data_is_empty_str = _ptrs_equal(synth, data, empty_str)
    _enforce_car_cdr_nil(synth, not_dummy, data_is_nil, nil, car, cdr)
    # "" -> car is nil, cdr is ""
    premise = bool_and(cs, not_dummy, data_is_empty_str)
    car.implies_ptr_equal(cs, premise, nil)
    cdr.implies_ptr_equal(cs, premise, empty_str)
    # otherwise the tuple2 hash must reproduce data's digest
    data_is_not_empty = bool_and(cs, data_is_nil.not_(),
                                 data_is_empty_str.not_())
    premise = bool_and(cs, not_dummy, data_is_not_empty)
    digest = hash_nums(synth, [car.tag, car.hash, cdr.tag, cdr.hash])
    implies_equal(cs, premise, data.hash, digest)
    return car, cdr, data_is_not_empty


def car_cdr_simple(synth: Synthesizer, not_dummy: Bool,
                   data: AllocatedPtr, data_ptr: Optional[Ptr]
                   ) -> Tuple[AllocatedPtr, AllocatedPtr, Bool]:
    """Cons-only car_cdr (gadgets.rs:662-728) — no string handling,
    fewer constraints. Returns (car, cdr, data_is_not_nil)."""
    cs = synth.cs
    store = synth.store
    if data_ptr is not None:
        car_p, cdr_p = store.car_cdr_simple(data_ptr)
        car = _advice_ptr(synth, car_p)
        cdr = _advice_ptr(synth, cdr_p)
    else:
        car = alloc_ptr(cs, 0, 0)
        cdr = alloc_ptr(cs, 0, 0)
    nil = synth.const_for_ptr(store.intern_nil())
    data_is_nil = _ptrs_equal(synth, data, nil)
    _enforce_car_cdr_nil(synth, not_dummy, data_is_nil, nil, car, cdr)
    data_is_not_nil = data_is_nil.not_()
    premise = bool_and(cs, not_dummy, data_is_not_nil)
    digest = hash_nums(synth, [car.tag, car.hash, cdr.tag, cdr.hash])
    implies_equal(cs, premise, data.hash, digest)
    return car, cdr, data_is_not_nil


def chain_car_cdr(synth: Synthesizer, not_dummy: Bool,
                  data: AllocatedPtr, data_ptr: Optional[Ptr], n: int,
                  simple: bool = False
                  ) -> Tuple[List[AllocatedPtr], AllocatedPtr, Num]:
    """Chain car_cdr `n` times (gadgets.rs:736-831): returns the n
    cars, the final cdr, and the explored length (<= n) counting
    non-empty deconstructions."""
    cs = synth.cs
    store = synth.store
    step = car_cdr_simple if simple else car_cdr
    host = store.car_cdr_simple if simple else store.car_cdr
    cars: List[AllocatedPtr] = []
    cdr, cdr_ptr = data, data_ptr
    length = Num.constant(cs, 0)
    one = Num.constant(cs, 1)
    zero = Num.constant(cs, 0)
    for _ in range(n):
        car, new_cdr, not_empty = step(synth, not_dummy, cdr, cdr_ptr)
        cars.append(car)
        if cdr_ptr is not None:
            _, cdr_ptr = host(cdr_ptr)
        cdr = new_cdr
        length = add(cs, length,
                         pick(cs, not_empty, one, zero))
    return cars, cdr, length
