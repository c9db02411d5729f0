"""Ptr pretty-printer: a copy of the JAX package's ``store/printer.py``
(parity: Ptr::fmt_to_string, reference src/lem/store.rs:897-1123)."""

from __future__ import annotations

from typing import Optional

from ..symbol import State, initial_lurk_state
from ..tags import ContTag, ExprTag, Op1, Op2
from .core import ATOM, COMPACT, TUPLE2, TUPLE4, Ptr, Store

_OP1_NAMES = {
    Op1.Car: "car#", Op1.Cdr: "cdr#", Op1.Atom: "atom#", Op1.Emit: "emit#",
    Op1.Open: "open#", Op1.Secret: "secret#", Op1.Commit: "commit#",
    Op1.Num: "num#", Op1.Comm: "comm#", Op1.Char: "char#",
    Op1.Eval: "eval#", Op1.U64: "u64#",
}
_OP2_NAMES = {
    Op2.Sum: "sum#", Op2.Diff: "diff#", Op2.Product: "product#",
    Op2.Quotient: "quotient#", Op2.Equal: "equal#", Op2.NumEqual: "numequal#",
    Op2.Less: "less#", Op2.Greater: "greater", Op2.LessEqual: "lessequal#",
    Op2.GreaterEqual: "greaterequal#", Op2.Cons: "cons",
    Op2.StrCons: "strcons#", Op2.Begin: "begin", Op2.Hide: "hide",
    Op2.Modulo: "modulo", Op2.Eval: "eval#",
}


def _to_u64(f: int) -> Optional[int]:
    return f if f < (1 << 64) else None


def fmt_to_string(ptr: Ptr, store: Store, state: State) -> str:
    t = ptr.tag
    E = ExprTag
    if t == E.Nil:
        sym = store.fetch_symbol(ptr)
        return state.fmt_to_string(sym) if sym is not None else "<Opaque Nil>"
    if t == E.Sym:
        sym = store.fetch_symbol(ptr)
        return state.fmt_to_string(sym) if sym is not None else "<Opaque Sym>"
    if t == E.Key:
        key = store.fetch_symbol(ptr)
        return state.fmt_to_string(key) if key is not None else "<Opaque Key>"
    if t == E.Str:
        s = store.fetch_string(ptr)
        return f'"{s}"' if s is not None else "<Opaque Str>"
    if t == E.Char:
        c = store.fetch_char(ptr)
        return f"'{c}'" if c is not None else "<Malformed Char>"
    if t == E.Cons:
        res = store.fetch_list(ptr)
        if res is None:
            return "<Opaque Cons>"
        lst, tail = res
        parts = [fmt_to_string(p, store, state) for p in lst]
        if tail is None:
            return "(" + " ".join(parts) + ")"
        return "(" + " ".join(parts) + " . " + \
            fmt_to_string(tail, store, state) + ")"
    if t == E.Num:
        f = store.fetch_f(ptr)
        if f is None:
            return "<Malformed Num>"
        u = _to_u64(f)
        if u is None:
            return "0x" + store.field.hex_digits(f)
        return str(u)
    if t == E.U64:
        f = store.fetch_f(ptr)
        u = _to_u64(f) if f is not None else None
        return f"{u}u64" if u is not None else "<Malformed U64>"
    if t in (E.Fun, E.Rec):
        label = "FUNCTION" if t == E.Fun else "REC_FUNCTION"
        if ptr.kind != TUPLE4:
            return f"<Malformed {'Fun' if t == E.Fun else 'Rec'}>"
        vars_, body, _env, _ = store.tuple4[ptr.idx]
        if vars_.tag == E.Nil:
            return f"<{label} () {fmt_to_string(body, store, state)}>"
        if vars_.tag == E.Cons:
            return (f"<{label} {fmt_to_string(vars_, store, state)}"
                    f" {fmt_to_string(body, store, state)}>")
        return f"<Malformed {'Fun' if t == E.Fun else 'Rec'}>"
    if t == E.Thunk:
        if ptr.kind != TUPLE2:
            return "<Malformed Thunk>"
        val, cont = store.tuple2[ptr.idx]
        return (f"Thunk{{ value: {fmt_to_string(val, store, state)}"
                f" => cont: {fmt_to_string(cont, store, state)} }}")
    if t == E.Comm:
        if ptr.kind != ATOM:
            return "<Malformed Comm>"
        f = store.atoms[ptr.idx]
        hexd = store.field.hex_digits(f)
        if store.can_open(f):
            return f"(comm 0x{hexd})"
        return f"<Opaque Comm 0x{hexd}>"
    if t == E.Cproc:
        if ptr.kind != TUPLE2:
            return "<Malformed Cproc>"
        name, args = store.tuple2[ptr.idx]
        return (f"<COPROC {fmt_to_string(name, store, state)}"
                f" {fmt_to_string(args, store, state)}>")
    if t == E.Env:
        env = store.fetch_env(ptr)
        if env is None:
            return "<Opaque Env>"
        parts = [
            f"({fmt_to_string(sym, store, state)}"
            f" . {fmt_to_string(val, store, state)})"
            for sym, val in env
        ]
        return "<ENV (" + " ".join(parts) + ")>"
    if t == E.Prov:
        if ptr.kind != COMPACT:
            return "<Opaque Prov>"
        query, val, deps = store.tuple3[ptr.idx]
        nil = store.intern_nil()
        q = fmt_to_string(query, store, state)
        v = fmt_to_string(val, store, state)
        if store.ptr_eq(deps, nil):
            return f"<Prov ({q} . {v})>"
        return f"<Prov ({q} . {v}) . {fmt_to_string(deps, store, state)}>"

    C = ContTag
    if t in (C.Outermost, C.Dummy, C.Error, C.Terminal, C.StreamStart,
             C.StreamDispatch, C.StreamPause):
        return {
            C.Outermost: "Outermost", C.Dummy: "Dummy", C.Error: "Error",
            C.Terminal: "Terminal", C.StreamStart: "StreamStart",
            C.StreamDispatch: "StreamDispatch", C.StreamPause: "StreamPause",
        }[t]
    if t == C.Emit:
        return "Emit <CONTINUATION>"
    cont_fields = {
        C.Call0: ("Call0", ("saved_env",)),
        C.Call: ("Call", ("unevaled_arg", "saved_env")),
        C.Call2: ("Call2", ("function", "saved_env")),
        C.Tail: ("Tail", ("saved_env",)),
        C.Lookup: ("Lookup", ("saved_env",)),
        C.Unop: ("Unop", ("saved_env",)),
        C.Binop: ("Binop", ("operator", "saved_env", "unevaled_args")),
        C.Binop2: ("Binop2", ("operator", "evaled_arg")),
        C.If: ("If", ("unevaled_args",)),
        C.Let: ("Let", ("var", "saved_env", "body")),
        C.LetRec: ("LetRec", ("var", "saved_env", "body")),
        C.Cproc: ("Cproc", ("name", "unevaled_args", "evaled_args")),
    }
    if t in cont_fields:
        name, fields = cont_fields[t]
        if ptr.kind != TUPLE4:
            return f"<Malformed {name}>"
        children = store.tuple4[ptr.idx]
        cont = children[len(fields)]
        inner = ", ".join(
            f"{fname}: {fmt_to_string(ch, store, state)}"
            for fname, ch in zip(fields, children)
        )
        return (f"{name}{{ {inner}, continuation: "
                f"{fmt_to_string(cont, store, state)} }}")
    if t in _OP1_NAMES:
        return _OP1_NAMES[Op1(t)]
    if t in _OP2_NAMES:
        return _OP2_NAMES[Op2(t)]
    return f"<Unknown tag {t:#06x}>"


def fmt_to_string_simple(ptr: Ptr, store: Store) -> str:
    return fmt_to_string(ptr, store, initial_lurk_state())
