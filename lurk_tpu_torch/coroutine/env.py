"""Env-lookup memoset query: the reference's second built-in query type
(the port of the JAX package's ``coroutine/env.py``; reference
functionality: src/coroutine/memoset/env.rs).

``(lurk.env.lookup . (var . env))`` walks the compact env binding chain
(the store's tuple3, hashed 4-ary) one binding per (memoized, deferred)
query: the result is ``(val . t)`` when ``var`` is the head binding,
``(nil . nil)`` on the empty env, and the recursive sub-query's result
otherwise. The circuit deconstructs one binding with advice and a hash4
implication, then issues the sub-query through the CircuitScope under a
condition: the shape does not depend on the witness (folding
uniformity)."""

from __future__ import annotations

from typing import Optional

from ..coproc.gadgets import construct_cons, hash_nums
from ..lem.circuit import AllocatedPtr
from ..r1cs.cs import SynthesisError
from ..r1cs.gadgets import (
    Num, alloc_equal, alloc_is_zero, alloc_num, bool_and, bool_or,
    implies_equal,
)
from ..store.core import Ptr, Store
from ..symbol import Symbol
from ..tags import ExprTag
from .circuit import CircuitQuery, CircuitScope, pick_ptr
from .memoset import Query, Scope

ENV_LOOKUP = Symbol(("lurk", "env", "lookup"), False)


class EnvQuery(Query):
    """Lookup(var, env): env.rs:18-115's behaviour."""

    def __init__(self, var: Ptr, env: Ptr):
        self.var = var
        self.env = env

    def symbol(self) -> Symbol:
        return ENV_LOOKUP

    def to_ptr(self, store: Store) -> Ptr:
        # (sym . (var . env)): the args ride as a dotted pair since both
        # are single field elements in the circuit (env.rs:71-83)
        args = store.cons(self.var, self.env)
        return store.cons(store.intern_symbol(ENV_LOOKUP), args)

    @classmethod
    def from_ptr(cls, store: Store, ptr: Ptr) -> Optional["EnvQuery"]:
        head, body = store.car_cdr(ptr)
        if store.fetch_symbol(head) != ENV_LOOKUP:
            return None
        var, env = store.car_cdr(body)
        return cls(var, env)

    def eval(self, scope: Scope) -> Ptr:
        s = scope.store
        popped = s.pop_binding(self.env)
        if popped is None:
            nil = s.intern_nil()
            return s.cons(nil, nil)
        v, val, new_env = popped
        if v == self.var:
            return s.cons(val, s.intern_t())
        sub = EnvQuery(self.var, new_env)
        return scope.query_recursively(self, sub)


class EnvCircuitQuery(CircuitQuery):
    """In-circuit single-binding step of the lookup (env.rs:128-208)."""

    def symbol(self) -> Symbol:
        return ENV_LOOKUP

    def synthesize_eval(self, scope: CircuitScope, key, key_ptr,
                        acc, not_dummy):
        synth, cs, s = scope.synth, scope.cs, scope.store

        # advice: (var, env) from the key; dummies use zeros
        var_ptr = env_ptr = None
        if key_ptr is not None:
            q = EnvQuery.from_ptr(s, key_ptr)
            if q is None:
                raise SynthesisError("an env circuit's key is not a "
                                     "lookup")
            var_ptr, env_ptr = q.var, q.env
        var_h = alloc_num(
            cs, s.hash_ptr(var_ptr).digest if var_ptr is not None else 0)
        env_h = alloc_num(
            cs, s.hash_ptr(env_ptr).digest if env_ptr is not None else 0)
        sym_tag = Num.constant(cs, int(ExprTag.Sym))
        env_tag = Num.constant(cs, int(ExprTag.Env))
        var = AllocatedPtr(sym_tag, var_h)
        env = AllocatedPtr(env_tag, env_h)

        # bind the advice to the key: key == (sym . (var . env))
        sym_const = synth.const_for_ptr(s.intern_symbol(ENV_LOOKUP))
        args = construct_cons(synth, var, env)
        rebuilt = construct_cons(synth, sym_const, args)
        implies_equal(cs, not_dummy, rebuilt.hash, key.hash)

        env_is_empty = alloc_is_zero(cs, env_h)
        have_binding = bool_and(cs, not_dummy, env_is_empty.not_())

        # deconstruct one binding (advice + hash4 implication):
        # env_digest == H(next_var_digest, val.tag, val.digest, rest)
        nv_val = vt_val = vh_val = ne_val = 0
        new_env_ptr = None
        if env_ptr is not None:
            popped = s.pop_binding(env_ptr)
            if popped is not None:
                bvar, bval, benv = popped
                nv_val = s.hash_ptr(bvar).digest
                zv = s.hash_ptr(bval)
                vt_val, vh_val = zv.tag, zv.digest
                ne_val = s.hash_ptr(benv).digest
                new_env_ptr = benv
        next_var = alloc_num(cs, nv_val)
        val = AllocatedPtr(alloc_num(cs, vt_val), alloc_num(cs, vh_val))
        new_env_h = alloc_num(cs, ne_val)
        digest = hash_nums(synth, [next_var, val.tag, val.hash,
                                   new_env_h])
        implies_equal(cs, have_binding, digest, env_h)

        var_matches = alloc_equal(cs, var_h, next_var)
        is_immediate = bool_or(cs, var_matches, env_is_empty)

        nil = synth.const_for_ptr(s.intern_nil())
        t = synth.const_for_ptr(s.intern_t())
        immediate_val = pick_ptr(cs, var_matches, val, nil)
        immediate_bound = pick_ptr(cs, var_matches, t, nil)
        immediate_result = construct_cons(synth, immediate_val,
                                          immediate_bound)

        # sub-query (lookup var new_env), issued when not immediate
        new_env = AllocatedPtr(env_tag, new_env_h)
        sub_args = construct_cons(synth, var, new_env)
        subkey = construct_cons(synth, sym_const, sub_args)
        sub_key_ptr = None
        if (key_ptr is not None and new_env_ptr is not None
                and nv_val != s.hash_ptr(var_ptr).digest):
            sub_key_ptr = EnvQuery(var_ptr, new_env_ptr).to_ptr(s)
        sub_not_dummy = bool_and(cs, not_dummy, is_immediate.not_())
        sub_res, sub_prov, acc_after = scope.synthesize_internal_query(
            subkey, sub_key_ptr, acc, sub_not_dummy)

        value = pick_ptr(cs, is_immediate, immediate_result, sub_res)
        new_acc = pick_ptr(cs, is_immediate, acc, acc_after)
        eff_dep = pick_ptr(cs, is_immediate, nil, sub_prov)
        prov = self.synthesize_provenance(scope, key, value, [eff_dep])
        return value, prov, new_acc
