"""LEM interpreter: runs a Func on Ptrs, producing a Frame with hints.

Parity: reference src/lem/interpreter.rs:49-583 (Hints, Frame,
Block::run, Func::call). Interpretation is index-based — no Poseidon
hashing happens here except for `EqVal` on opaque data; hint slots record
preimage pointers for the circuit's slot gadgets.

Slot entries are ``("ptr", Ptr)`` (contributes tag+digest to the preimage)
or ``("num", Ptr)`` (contributes digest only — used by PushBinding/
PopBinding/Hide/Open/bit-decomposition slots).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..store.core import ATOM, Ptr, Store
from ..tags import ExprTag
from . import ir
from .slots import BIT_DECOMP, COMMITMENT, HASH4, HASH6, HASH8

SlotEntry = Tuple[str, Ptr]          # ("ptr"|"num", Ptr)
SlotData = Tuple[SlotEntry, ...]


@dataclasses.dataclass
class Hints:
    """Non-deterministic hints collected per frame (interpreter.rs:49-100)."""

    hash4: List[Optional[SlotData]] = dataclasses.field(default_factory=list)
    hash6: List[Optional[SlotData]] = dataclasses.field(default_factory=list)
    hash8: List[Optional[SlotData]] = dataclasses.field(default_factory=list)
    commitment: List[Optional[SlotData]] = dataclasses.field(
        default_factory=list)
    bit_decomp: List[Optional[SlotData]] = dataclasses.field(
        default_factory=list)
    # advice bindings for unconstrained allocations (Recv/Cproc/Call outputs)
    bindings: Dict[str, Ptr] = dataclasses.field(default_factory=dict)

    def get(self, slot_type: str) -> List[Optional[SlotData]]:
        return getattr(self, slot_type)

    @staticmethod
    def blank(func: ir.Func) -> "Hints":
        sc = func.slots_count
        return Hints(
            hash4=[None] * sc.hash4,
            hash6=[None] * sc.hash6,
            hash8=[None] * sc.hash8,
            commitment=[None] * sc.commitment,
            bit_decomp=[None] * sc.bit_decomp,
        )


@dataclasses.dataclass
class Frame:
    input: List[Ptr]
    output: List[Ptr]
    hints: Hints
    blank: bool = False
    pc: int = 0

    @staticmethod
    def blank_frame(func: ir.Func, pc: int, store: Store) -> "Frame":
        dummy = store.dummy()
        return Frame(
            input=[dummy] * len(func.input_params),
            output=[dummy] * func.output_size,
            hints=Hints.blank(func),
            blank=True,
            pc=pc,
        )


class Channel:
    """Dual-channel terminal (dual_channel.rs:13-68): crossed FIFO pair."""

    def __init__(self):
        from collections import deque
        self._inbound = deque()
        self.outbound: List[Ptr] = []

    def send(self, ptr: Ptr) -> None:
        self.outbound.append(ptr)

    def feed(self, ptr: Ptr) -> None:
        """Host side: enqueue a value for the program's next `recv`."""
        self._inbound.append(ptr)

    def recv(self) -> Ptr:
        if not self._inbound:
            raise RuntimeError("recv on empty channel")
        return self._inbound.popleft()


def dummy_channel() -> Channel:
    return Channel()


class EvalError(Exception):
    """Interpretation error (reduction error, reference anyhow bails)."""


def _signed_lt(p: int, f: int, g: int) -> bool:
    """Lurk Num ordering (src/num.rs:203-241): elements above (p-1)/2 are
    negative."""
    half = (p - 1) // 2
    sf = f if f <= half else f - p
    sg = g if g <= half else g - p
    return sf < sg


class Interpreter:
    """Stateful executor for LEM Funcs against one Store."""

    def __init__(self, store: Store,
                 cprocs: Optional[Dict["object", Callable]] = None,
                 crout: Optional[Callable] = None):
        self.store = store
        # Lang: Symbol -> coprocessor callable (ptrs...) -> [ptrs]
        self.cprocs = cprocs or {}
        # coroutine dispatch (Op::Crout): (sym, [ptrs]) -> [ptrs],
        # normally a memoset Scope query (lem/coroutine/eval.rs parity)
        self.crout = crout

    # -- value helpers -----------------------------------------------------

    def _eq_val(self, a: Ptr, b: Ptr) -> bool:
        """Content equality of vals (interpreter.rs EqVal: resolves hashes
        so opaque data compares correctly). Fast paths avoid hashing."""
        if a.val == b.val:
            return True
        store = self.store
        if a.kind != ATOM and b.kind != ATOM:
            # distinct hash-consed compound entries have distinct digests
            # only if their kinds differ can preimages still collide by
            # construction; hash to be safe when kinds differ
            if a.kind == b.kind:
                return False
        return store.hash_ptr_val(a.val) == store.hash_ptr_val(b.val)

    def _lit_to_ptr(self, lit: ir.Lit) -> Ptr:
        store = self.store
        if lit.kind == ir.LIT_NUM:
            return store.num(lit.value % store.field.modulus)
        if lit.kind == ir.LIT_STRING:
            return store.intern_string(lit.value)
        return store.intern_symbol(lit.value)

    # -- main entry --------------------------------------------------------

    def call(self, func: ir.Func, args: Sequence[Ptr], channel: Channel,
             pc: int = 0) -> Frame:
        assert len(args) == len(func.input_params)
        hints = Hints()
        output = self._call_func(func, args, hints, channel)
        return Frame(input=list(args), output=output, hints=hints, pc=pc)

    def _call_func(self, func: ir.Func, args: Sequence[Ptr], hints: Hints,
                   channel: Channel) -> List[Ptr]:
        """Run a Func body, then pad unused slots with None so that slot
        indices align with circuit synthesis (interpreter.rs:547-581)."""
        from .slots import SLOT_TYPES
        init = {st: len(hints.get(st)) for st in SLOT_TYPES}
        bindings: Dict[str, object] = dict(zip(func.input_params, args))
        output = self._run_block(func.body, bindings, hints, channel)
        for st in SLOT_TYPES:
            lst = hints.get(st)
            used = len(lst) - init[st]
            for _ in range(used, func.slots_count.get(st)):
                lst.append(None)
        return output

    # -- block execution ---------------------------------------------------

    def _run_block(self, blk: ir.Block, bindings: Dict[str, object],
                   hints: Hints, channel: Channel) -> List[Ptr]:
        store = self.store
        while True:
            for op in blk.ops:
                self._run_op(op, bindings, hints, channel)
            c = blk.ctrl
            if isinstance(c, ir.Return):
                return [bindings[v] for v in c.vars]
            if isinstance(c, ir.If):
                b = bindings[c.var]
                assert isinstance(b, bool), f"{c.var} is not a boolean"
                blk = c.true_block if b else c.false_block
                continue
            if isinstance(c, ir.MatchTag):
                ptr: Ptr = bindings[c.var]
                for tag, case_blk in c.cases:
                    if ptr.tag == tag:
                        blk = case_blk
                        break
                else:
                    if c.default is None:
                        raise EvalError(f"no match for tag {ptr.tag:#06x}")
                    blk = c.default
                continue
            assert isinstance(c, ir.MatchValue)
            ptr = bindings[c.var]
            expected_tag = {
                ir.LIT_NUM: ExprTag.Num,
                ir.LIT_STRING: ExprTag.Str,
                ir.LIT_SYMBOL: ExprTag.Sym,
            }[c.lit_type]
            if ptr.tag != expected_tag:
                raise EvalError(
                    f"{c.var} is not a value of type {c.lit_type}")
            for lit, case_blk in c.cases:
                lit_ptr = self._lit_to_ptr(lit)
                if ptr.val == lit_ptr.val:
                    blk = case_blk
                    break
            else:
                if c.default is None:
                    raise EvalError("no match for value")
                blk = c.default
            continue

    # -- op execution ------------------------------------------------------

    def _run_op(self, op: ir.Op, b: Dict[str, object], hints: Hints,
                channel: Channel) -> None:
        store = self.store
        k = op[0]
        if k == ir.CALL:
            _, outs, func, ins = op
            args = [b[v] for v in ins]
            # threads the same hints object through the callee, padding its
            # unused slots (Func::call parity)
            out = self._call_func(func, args, hints, channel)
            for var, ptr in zip(outs, out):
                b[var] = ptr
                hints.bindings[var] = ptr
        elif k == ir.CPROC:
            _, outs, sym, ins = op
            cproc = self.cprocs.get(sym)
            if cproc is None:
                raise EvalError(f"coprocessor for {sym} not found")
            args = [b[v] for v in ins]
            out_ptrs = cproc(store, args)
            assert len(outs) == len(out_ptrs)
            for var, ptr in zip(outs, out_ptrs):
                b[var] = ptr
                hints.bindings[var] = ptr
        elif k == ir.CROUT:
            _, outs, sym, ins = op
            if self.crout is None:
                raise EvalError(
                    f"coroutine {sym} invoked without a scope")
            args = [b[v] for v in ins]
            out_ptrs = self.crout(sym, args)
            assert len(outs) == len(out_ptrs)
            for var, ptr in zip(outs, out_ptrs):
                b[var] = ptr
                hints.bindings[var] = ptr
        elif k == ir.COPY:
            b[op[1]] = b[op[2]]
        elif k == ir.ZERO:
            b[op[1]] = store.zero(op[2])
        elif k == ir.HASH3ZEROS:
            b[op[1]] = Ptr(op[2], ATOM, store.hash3zeros_idx)
        elif k == ir.HASH4ZEROS:
            b[op[1]] = Ptr(op[2], ATOM, store.hash4zeros_idx)
        elif k == ir.HASH6ZEROS:
            b[op[1]] = Ptr(op[2], ATOM, store.hash6zeros_idx)
        elif k == ir.HASH8ZEROS:
            b[op[1]] = Ptr(op[2], ATOM, store.hash8zeros_idx)
        elif k == ir.LITOP:
            b[op[1]] = self._lit_to_ptr(op[2])
        elif k == ir.CAST:
            src: Ptr = b[op[3]]
            b[op[1]] = Ptr(op[2], src.kind, src.idx)
        elif k == ir.EQTAG:
            b[op[1]] = b[op[2]].tag == b[op[3]].tag
        elif k == ir.EQVAL:
            b[op[1]] = self._eq_val(b[op[2]], b[op[3]])
        elif k == ir.NOT:
            b[op[1]] = not b[op[2]]
        elif k == ir.AND:
            b[op[1]] = b[op[2]] and b[op[3]]
        elif k == ir.OR:
            b[op[1]] = b[op[2]] or b[op[3]]
        elif k in (ir.ADD, ir.SUB, ir.MUL, ir.DIV):
            f = self._atom_f(b[op[2]], k)
            g = self._atom_f(b[op[3]], k)
            p = store.field.modulus
            if k == ir.ADD:
                v = (f + g) % p
            elif k == ir.SUB:
                v = (f - g) % p
            elif k == ir.MUL:
                v = (f * g) % p
            else:
                if g == 0:
                    raise EvalError("Can't divide by zero")
                v = (f * pow(g, p - 2, p)) % p
            b[op[1]] = store.intern_atom(ExprTag.Num, v)
        elif k == ir.LT:
            f = self._atom_f(b[op[2]], k)
            g = self._atom_f(b[op[3]], k)
            p = store.field.modulus
            diff = (f - g) % p
            for dbl in (2 * f % p, 2 * g % p, 2 * diff % p):
                hints.bit_decomp.append(
                    (("num", store.intern_atom(ExprTag.Num, dbl)),))
            b[op[1]] = _signed_lt(p, f, g)
        elif k == ir.TRUNC:
            n = op[3]
            assert n <= 64
            a: Ptr = b[op[2]]
            f = self._atom_f(a, k)
            hints.bit_decomp.append((("num", a),))
            mask = (1 << n) - 1
            # to_u64_unchecked: low 64 bits of the LE repr
            b[op[1]] = store.intern_atom(
                ExprTag.Num, (f & ((1 << 64) - 1)) & mask)
        elif k == ir.DIVREM64:
            f = self._atom_f(b[op[2]], k) & ((1 << 64) - 1)
            g = self._atom_f(b[op[3]], k) & ((1 << 64) - 1)
            if g == 0:
                raise EvalError("Can't divide by zero")
            b[op[1][0]] = store.intern_atom(ExprTag.Num, f // g)
            b[op[1][1]] = store.intern_atom(ExprTag.Num, f % g)
        elif k == ir.EMIT:
            channel.send(b[op[1]])
        elif k == ir.RECV:
            ptr = channel.recv()
            b[op[1]] = ptr
            hints.bindings[op[1]] = ptr
        elif k == ir.CONS2:
            ptrs = [b[v] for v in op[3]]
            b[op[1]] = store.intern_tuple2(ptrs, op[2])
            hints.hash4.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.CONS3:
            ptrs = [b[v] for v in op[3]]
            b[op[1]] = store.intern_tuple3(ptrs, op[2])
            hints.hash6.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.CONS4:
            ptrs = [b[v] for v in op[3]]
            b[op[1]] = store.intern_tuple4(ptrs, op[2])
            hints.hash8.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.DECONS2:
            img: Ptr = b[op[2]]
            ptrs = self._fetch(img, 2)
            for var, ptr in zip(op[1], ptrs):
                b[var] = ptr
            hints.hash4.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.DECONS3:
            img = b[op[2]]
            ptrs = self._fetch(img, 3)
            for var, ptr in zip(op[1], ptrs):
                b[var] = ptr
            hints.hash6.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.DECONS4:
            img = b[op[2]]
            ptrs = self._fetch(img, 4)
            for var, ptr in zip(op[1], ptrs):
                b[var] = ptr
            hints.hash8.append(tuple(("ptr", x) for x in ptrs))
        elif k == ir.PUSHBINDING:
            sym, val, env = (b[v] for v in op[2])
            img_ptr = store.push_binding(sym, val, env)
            b[op[1]] = img_ptr
            hints.hash4.append(
                (("num", sym), ("ptr", val), ("num", env)))
        elif k == ir.POPBINDING:
            img = b[op[2]]
            res = store.pop_binding(img)
            if res is None:
                raise EvalError("cannot extract binding")
            for var, ptr in zip(op[1], res):
                b[var] = ptr
            sym, val, env = res
            hints.hash4.append(
                (("num", sym), ("ptr", val), ("num", env)))
        elif k == ir.HIDE:
            payload: Ptr = b[op[3]]
            sec: Ptr = b[op[2]]
            if sec.tag != ExprTag.Num or sec.kind != ATOM:
                raise EvalError("hide secret is not a numeric pointer")
            secret = store.atoms[sec.idx]
            comm_digest, _ = store.hide_and_return_z_payload(secret, payload)
            b[op[1]] = store.comm(comm_digest)
            hints.commitment.append((("num", sec), ("ptr", payload)))
        elif k == ir.OPEN:
            comm: Ptr = b[op[3]]
            if comm.tag != ExprTag.Comm or comm.kind != ATOM:
                raise EvalError("open argument is not a comm pointer")
            digest = store.atoms[comm.idx]
            res = store.open(digest)
            if res is None:
                raise EvalError(
                    f"no committed data for hash {digest:#x}")
            secret, payload = res
            sec_ptr = store.intern_atom(ExprTag.Num, secret)
            b[op[2]] = payload
            b[op[1]] = sec_ptr
            hints.commitment.append((("num", sec_ptr), ("ptr", payload)))
        else:
            raise ValueError(f"unknown op kind {k}")

    def _atom_f(self, ptr: Ptr, opname: str) -> int:
        if ptr.kind != ATOM:
            raise EvalError(f"`{opname}` only works on atoms")
        return self.store.atoms[ptr.idx]

    def _fetch(self, img: Ptr, n: int) -> Tuple[Ptr, ...]:
        store = self.store
        from ..store.core import COMPACT, TUPLE2, TUPLE3, TUPLE4
        if n == 2 and img.kind == TUPLE2:
            return store.tuple2[img.idx]
        if n == 3 and img.kind == TUPLE3:
            return store.tuple3[img.idx]
        if n == 4 and img.kind == TUPLE4:
            return store.tuple4[img.idx]
        raise EvalError(f"pointer is not a Tuple{n}")
