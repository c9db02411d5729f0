"""Toplevel LEM coroutines: LEM Funcs as memoset queries (Op::Crout).

The port of the JAX package's ``coroutine/toplevel.py`` (reference
functionality: src/lem/coroutine/{toplevel,eval,synthesis}.rs). A
``Toplevel`` is an ordered map Symbol -> Coroutine(Func); a
``ToplevelQuery`` evaluates its coroutine's Func through the LEM
interpreter, with every ``Op::Crout`` dispatched as a recursive memoset
query (``Scope.query_recursively``), so mutually recursive coroutines
get memoized, deferred-proof semantics. ``ToplevelCircuitQuery``
synthesizes the same Func with every ``Op::Crout`` dispatched as an
internal query of the memoset circuit.

Query key encoding (toplevel.rs:200-236): ``(name . args)`` with args
as an IMPROPER list, the final argument the cdr: ``(factorial . 5)``
for one argument, ``(f a . b)`` for two.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from ..coproc.gadgets import construct_cons
from ..lem import ir
from ..lem.circuit import (
    SlotCounters, SynthesisCtx, Synthesizer, alloc_ptr, allocate_slot,
)
from ..lem.interpreter import Frame, Hints, Interpreter, dummy_channel
from ..lem.slots import SLOT_TYPES
from ..r1cs.cs import SynthesisError
from ..r1cs.gadgets import implies_equal
from ..store.core import Ptr, Store
from ..symbol import Symbol
from .circuit import CircuitQuery, pick_ptr
from .memoset import Query, Scope


@dataclasses.dataclass
class Coroutine:
    """One LEM-authored coroutine (toplevel.rs:21-33)."""

    func: ir.Func
    rc: int = 1


class Toplevel:
    """Ordered coroutine registry (toplevel.rs:36-49)."""

    def __init__(self, funcs: List[Tuple[Symbol, ir.Func]]):
        self._map: Dict[Symbol, Coroutine] = {
            sym: Coroutine(ir.deconflict_func(func))
            for sym, func in funcs
        }
        # the names and LEM bodies in order: what the circuits of the
        # coroutines depend on
        self.digest = hashlib.sha256(
            repr(list(self._map.items())).encode()).hexdigest()

    def get(self, name: Symbol) -> Optional[Coroutine]:
        return self._map.get(name)

    def index_of(self, name: Symbol) -> int:
        return list(self._map).index(name)

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self):
        return iter(self._map.items())


def to_improper_list(store: Store, ptrs: List[Ptr]) -> Ptr:
    """[a] -> a;  [a, b, c] -> (a b . c)  (toplevel.rs to_improper_list)."""
    if not ptrs:
        raise ValueError("an improper list needs at least one element")
    if len(ptrs) == 1:
        return ptrs[0]
    return store.improper_list(ptrs[:-1], ptrs[-1])


class ToplevelQuery(Query):
    """A (name, args) query against a Toplevel (toplevel.rs:52-85)."""

    toplevel: Toplevel = None     # bound by make_query_cls

    def __init__(self, name: Symbol, args: List[Ptr]):
        coroutine = self.toplevel.get(name)
        if coroutine is None:
            raise ValueError(f"`{name}` not found in the toplevel")
        want = len(coroutine.func.input_params)
        if len(args) != want:
            raise ValueError(
                f"wrong number of arguments: expected {want}, "
                f"found {len(args)}")
        self.name = name
        self.args = args

    def symbol(self) -> Symbol:
        return self.name

    def index(self) -> int:
        return self.toplevel.index_of(self.name)

    def to_ptr(self, store: Store) -> Ptr:
        return store.cons(store.intern_symbol(self.name),
                          to_improper_list(store, self.args))

    @classmethod
    def from_ptr(cls, store: Store, ptr: Ptr) -> Optional["ToplevelQuery"]:
        head, acc = store.car_cdr(ptr)
        name = store.fetch_symbol(head)
        if name is None or cls.toplevel.get(name) is None:
            return None
        num_args = len(cls.toplevel.get(name).func.input_params)
        if num_args == 0:
            raise ValueError("cannot yet make 0 argument queries")
        args = []
        while len(args) < num_args - 1:
            car, acc = store.car_cdr(acc)
            args.append(car)
        args.append(acc)
        return cls(name, args)

    def eval(self, scope: Scope) -> Ptr:
        coroutine = self.toplevel.get(self.name)

        def crout(sym: Symbol, args: List[Ptr]) -> List[Ptr]:
            child = type(self)(sym, list(args))
            return [scope.query_recursively(self, child)]

        interp = Interpreter(scope.store, crout=crout)
        outs = interp._call_func(coroutine.func, list(self.args),
                                 Hints(), dummy_channel())
        return to_improper_list(scope.store, list(outs))


def make_query_cls(toplevel: Toplevel):
    """Bind a Toplevel into a Scope-compatible query class (the
    reference threads it as Scope::runtime_data)."""
    return type("BoundToplevelQuery", (ToplevelQuery,),
                {"toplevel": toplevel})


class ToplevelCircuitQuery(CircuitQuery):
    """In-circuit evaluator for toplevel coroutines: synthesizes the
    coroutine's LEM Func with every Op::Crout dispatched as an internal
    memoset query (reference src/lem/coroutine/{toplevel,synthesis}.rs).

    The dependency convention matches the reference: one picked (nil
    when the site is not taken) provenance per Crout SITE, in synthesis
    order; host and circuit provenance hashes agree for coroutines whose
    taken sites coincide with their syntactic sites (the reference's own
    supported class)."""

    def __init__(self, toplevel: Toplevel, dummy_name: Symbol = None):
        self.toplevel = toplevel
        self.dummy_name = dummy_name

    def for_index(self, index: int) -> "ToplevelCircuitQuery":
        """One query circuit per coroutine (NIVC circuit index = the
        coroutine's toplevel index); dummy slots synthesize ITS func."""
        name = list(self.toplevel)[index][0]
        return ToplevelCircuitQuery(self.toplevel, name)

    def circuits_key(self) -> tuple:
        return super().circuits_key() + (self.toplevel.digest,)

    def symbol(self) -> Symbol:
        return self.dummy_name

    def symbol_for_key(self, store: Store, key_ptr: Ptr) -> Symbol:
        head, _ = store.car_cdr(key_ptr)
        return store.fetch_symbol(head)

    def synthesize_eval(self, scope, key, key_ptr, acc, not_dummy):
        s = scope.store
        cs = scope.cs
        synth0 = scope.synth
        # which coroutine? fixed per circuit index: from the key when
        # real, else the index's registered coroutine
        if key_ptr is not None:
            name = self.symbol_for_key(s, key_ptr)
        else:
            name = self.dummy_name
            if name is None:
                raise SynthesisError(
                    "dummy toplevel slot needs for_index() binding")
        coroutine = self.toplevel.get(name)
        if coroutine is None:
            raise SynthesisError(
                f"`{name}` is not a coroutine of the toplevel")
        func = coroutine.func
        n_args = len(func.input_params)

        # host-side frame (hints + recorded crout calls, taken order)
        calls: List[Tuple[Symbol, List[Ptr], Ptr]] = []
        if key_ptr is not None:
            qcls = make_query_cls(self.toplevel)
            query = qcls.from_ptr(s, key_ptr)
            if query is None:
                raise SynthesisError(
                    "a toplevel circuit's key is not a query of its "
                    "toplevel")

            def crout(sym: Symbol, args: List[Ptr]) -> List[Ptr]:
                child = qcls(sym, list(args))
                child_ptr = child.to_ptr(s)
                result = scope.scope.queries[child_ptr]
                calls.append((sym, list(args), child_ptr))
                return [result]

            interp = Interpreter(s, crout=crout)
            frame = interp.call(func, list(query.args), dummy_channel())
            arg_hosts: Optional[List[Ptr]] = list(query.args)
        else:
            frame = Frame.blank_frame(func, 0, s)
            arg_hosts = None

        # allocate args as advice; bind to the key under not_dummy
        arg_allocs = []
        for i in range(n_args):
            if arg_hosts is not None:
                z = s.hash_ptr(arg_hosts[i])
                arg_allocs.append(alloc_ptr(cs, z.tag, z.digest))
            else:
                arg_allocs.append(alloc_ptr(cs, 0, 0))
        name_const = synth0.const_for_ptr(s.intern_symbol(name))
        args_list = arg_allocs[-1]
        for aptr in reversed(arg_allocs[:-1]):
            args_list = construct_cons(synth0, aptr, args_list)
        rebuilt = construct_cons(synth0, name_const, args_list)
        implies_equal(cs, not_dummy, rebuilt.hash, key.hash)

        # LEM synthesis with Crout dispatched through the memoset scope
        acc_cell = [acc]
        dep_provs: List = []
        nil_const = synth0.const_for_ptr(s.intern_nil())
        call_iter = iter(calls)

        def crout_synth(synth, nd, sym, arg_ptrs):
            subkey = arg_ptrs[-1]
            for aptr in reversed(arg_ptrs[:-1]):
                subkey = construct_cons(synth, aptr, subkey)
            subkey = construct_cons(
                synth, synth.const_for_ptr(s.intern_symbol(sym)), subkey)
            child_ptr = None
            if nd.value and key_ptr is not None:
                _, _, child_ptr = next(call_iter)
            res, prov, new_acc = scope.synthesize_internal_query(
                subkey, child_ptr, acc_cell[0], nd)
            acc_cell[0] = pick_ptr(cs, nd, new_acc, acc_cell[0])
            dep_provs.append(pick_ptr(cs, nd, prov, nil_const))
            return [res]

        slots = {}
        for st in SLOT_TYPES:
            datas = frame.hints.get(st)
            if len(datas) != func.slots_count.get(st):
                raise SynthesisError(
                    f"{len(datas)} {st} slots in the frame of {name}, its "
                    f"Func has {func.slots_count.get(st)}")
            slots[st] = [allocate_slot(cs, d, st, s) for d in datas]
        ctx = SynthesisCtx(
            cs=cs, store=s, slots=slots, blank=frame.blank,
            hint_bindings=frame.hints.bindings, cproc_synthesizers={},
            crout_synthesizer=crout_synth)
        outs = Synthesizer(ctx).synthesize_func(
            func, arg_allocs, not_dummy, SlotCounters(), frame.output)

        # result value = improper list of the outputs (toplevel.rs
        # to_allocated_improper_list)
        value = outs[-1]
        for aptr in reversed(outs[:-1]):
            value = construct_cons(synth0, aptr, value)
        prov = self.synthesize_provenance(scope, key, value, dep_provs)
        return value, prov, acc_cell[0]


def scope_for(toplevel: Toplevel, store: Store,
              default_rc: int = 1) -> Scope:
    return Scope(store, make_query_cls(toplevel), default_rc)
