"""LEM -> R1CS compiler: synthesizes a Func + Frame into constraints.

A copy of the JAX package's ``lem/circuit.py``, on the port's store and
LEM. Semantics parity: reference src/lem/circuit.rs:567-1530
(synthesize_block, synthesize_match, allocate_return, allocate_slot,
Func::synthesize_frame). Differences by design:

  - Constants are free linear combinations instead of allocated variables
    (bellpepper allocates one aux + one constraint per global constant);
    the circuit is smaller, uniformity is unaffected.
  - Poseidon slots use
    :func:`lurk_tpu_torch.poseidon.circuit.poseidon_circuit` (3
    constraints per S-box) instead of neptune's circuit2; witness-only
    systems take the host C++ trace (``poseidon_witness``).
  - The shape is extracted from ANY frame's synthesis (uniformity is
    enforced by construction: allocation order never depends on values)
    and pinned by tests comparing shape digests across frames and blanks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..poseidon.circuit import poseidon_circuit, poseidon_witness
from ..r1cs.cs import ConstraintSystem, SynthesisError
from ..r1cs.gadgets import (
    Bool, Num, add, alloc_bit, alloc_equal, alloc_is_zero, alloc_num,
    bool_and, bool_or, bool_xor, div, enforce_product_and_sum,
    enforce_selector_with_premise, implies_equal, implies_equal_const,
    implies_pack, implies_u64, implies_unequal_const, mul, pick, sub,
    to_bits_le_strict,
)
from ..store.core import Ptr, Store
from ..tags import ExprTag
from . import ir
from .interpreter import Frame
from .slots import (
    BIT_DECOMP, COMMITMENT, HASH4, HASH6, HASH8, PREIMG_SIZE, SLOT_TYPES,
)


@dataclasses.dataclass
class AllocatedPtr:
    tag: Num
    hash: Num

    def implies_ptr_equal(self, cs: ConstraintSystem, premise: Bool,
                          other: "AllocatedPtr") -> None:
        implies_equal(cs, premise, self.tag, other.tag)
        implies_equal(cs, premise, self.hash, other.hash)


def alloc_ptr(cs: ConstraintSystem, tag_f: int, hash_f: int
              ) -> AllocatedPtr:
    return AllocatedPtr(alloc_num(cs, tag_f), alloc_num(cs, hash_f))


def const_ptr(cs: ConstraintSystem, tag_f: int, hash_f: int
              ) -> AllocatedPtr:
    return AllocatedPtr(Num.constant(cs, tag_f), Num.constant(cs, hash_f))


# slot allocation: (preimage nums, image) where image is a Num (hashes) or
# a list of Bools (bit decomposition)
Slot = Tuple[List[Num], object]


def allocate_slot(cs: ConstraintSystem, slot_data, slot_type: str,
                  store: Store) -> Slot:
    """circuit.rs:249-315: allocate (dummy-filled) preimage + image."""
    preimg: List[Num] = []
    if slot_data is not None:
        for kind, ptr in slot_data:
            if kind == "ptr":
                z_tag, z_hash = ptr.tag, store.hash_ptr_val(ptr.val)
                preimg.append(alloc_num(cs, z_tag))
                preimg.append(alloc_num(cs, z_hash))
            else:  # "num": digest/value only
                preimg.append(alloc_num(cs, store.hash_ptr_val(ptr.val)))
        assert len(preimg) == PREIMG_SIZE[slot_type], \
            f"slot data incompatible with {slot_type}"
    else:
        preimg = [alloc_num(cs, 0) for _ in range(PREIMG_SIZE[slot_type])]
    if slot_type == BIT_DECOMP:
        img: object = to_bits_le_strict(cs, preimg[0])
    elif cs.witness_only:
        img = poseidon_witness(cs, store.field, preimg)
    else:
        img = poseidon_circuit(cs, store.field, preimg)
    return preimg, img


class SlotCounters:
    def __init__(self):
        self.idx: Dict[str, int] = {st: 0 for st in SLOT_TYPES}

    def consume(self, st: str) -> int:
        i = self.idx[st]
        self.idx[st] = i + 1
        return i

    def copy(self) -> "SlotCounters":
        c = SlotCounters()
        c.idx = dict(self.idx)
        return c

    def max_with(self, other: "SlotCounters") -> None:
        for st in SLOT_TYPES:
            self.idx[st] = max(self.idx[st], other.idx[st])


@dataclasses.dataclass
class SynthesisCtx:
    cs: ConstraintSystem
    store: Store
    slots: Dict[str, List[Slot]]
    blank: bool
    hint_bindings: Dict[str, Ptr]
    cproc_synthesizers: Dict[object, object]  # Symbol -> CoCircuit
    # Op::Crout dispatch of the memoset coroutine circuits
    # (synthesis.rs:114-141): (synth, not_dummy, sym, arg_ptrs) -> outs
    crout_synthesizer: object = None


class Synthesizer:
    """One Func + Frame synthesis walk."""

    def __init__(self, ctx: SynthesisCtx):
        self.ctx = ctx
        self.cs = ctx.cs
        self.store = ctx.store
        self.p = ctx.cs.p

    # -- constants -----------------------------------------------------------

    def const_for_ptr(self, ptr: Ptr) -> AllocatedPtr:
        z = self.store.hash_ptr(ptr)
        return const_ptr(self.cs, z.tag, z.digest)

    def _lit_ptr(self, lit: ir.Lit) -> Ptr:
        store = self.store
        if lit.kind == ir.LIT_NUM:
            return store.num(lit.value % store.field.modulus)
        if lit.kind == ir.LIT_STRING:
            return store.intern_string(lit.value)
        return store.intern_symbol(lit.value)

    # -- slots -----------------------------------------------------------------

    def _slot(self, st: str, counters: SlotCounters) -> Slot:
        return self.ctx.slots[st][counters.consume(st)]

    # -- entry -----------------------------------------------------------------

    def synthesize_func(self, func: ir.Func,
                        inputs: Sequence[AllocatedPtr],
                        not_dummy: Bool,
                        counters: SlotCounters,
                        output_hints: Sequence[Ptr]
                        ) -> List[AllocatedPtr]:
        bound: Dict[str, object] = dict(zip(func.input_params, inputs))
        branch_outputs: List[Tuple[Bool, List[AllocatedPtr]]] = []
        self.synthesize_block(func.body, branch_outputs, not_dummy,
                              counters, bound)
        return self.allocate_return(branch_outputs, output_hints)

    def allocate_return(self, branches, output_hints
                        ) -> List[AllocatedPtr]:
        assert branches
        if len(branches) == 1:
            return branches[0][1]
        output = []
        for ptr in output_hints:
            z = self.store.hash_ptr(ptr)
            output.append(alloc_ptr(self.cs, z.tag, z.digest))
        for select, ptrs in branches:
            for ptr, ret_ptr in zip(ptrs, output):
                ptr.implies_ptr_equal(self.cs, select, ret_ptr)
        return output

    # -- blocks ------------------------------------------------------------------

    def synthesize_block(self, blk: ir.Block, branch_outputs,
                         not_dummy: Bool, counters: SlotCounters,
                         bound: Dict[str, object]) -> None:
        for op in blk.ops:
            self.synthesize_op(op, not_dummy, counters, bound)
        c = blk.ctrl
        cs = self.cs
        if isinstance(c, ir.Return):
            branch_outputs.append(
                (not_dummy, [bound[v] for v in c.vars]))
        elif isinstance(c, ir.If):
            b: Bool = bound[c.var]
            b_nd = bool_and(cs, b, not_dummy)
            nb_nd = bool_and(cs, b.not_(), not_dummy)
            branch_counters = counters.copy()
            self.synthesize_block(c.true_block, branch_outputs, b_nd,
                                  branch_counters, dict(bound))
            self.synthesize_block(c.false_block, branch_outputs, nb_nd,
                                  counters, dict(bound))
            counters.max_with(branch_counters)
        elif isinstance(c, ir.MatchTag):
            matched: AllocatedPtr = bound[c.var]
            cases = [(t % self.p, blk_) for t, blk_ in c.cases]
            self.synthesize_match(matched.tag, cases, c.default,
                                  branch_outputs, not_dummy, counters,
                                  bound)
        else:
            assert isinstance(c, ir.MatchValue)
            matched = bound[c.var]
            cases = []
            for lit, blk_ in c.cases:
                lit_ptr = self._lit_ptr(lit)
                cases.append(
                    (self.store.hash_ptr(lit_ptr).digest, blk_))
            self.synthesize_match(matched.hash, cases, c.default,
                                  branch_outputs, not_dummy, counters,
                                  bound)
            # enforce MatchValue's tag
            lit_tag = {
                ir.LIT_NUM: ExprTag.Num,
                ir.LIT_STRING: ExprTag.Str,
                ir.LIT_SYMBOL: ExprTag.Sym,
            }[c.lit_type]
            implies_equal_const(cs, not_dummy, matched.tag, int(lit_tag))

    def synthesize_match(self, matched: Num, cases, default,
                         branch_outputs, not_dummy: Bool,
                         counters: SlotCounters, bound) -> None:
        """circuit.rs:1203-1298: selector bits + implications."""
        cs = self.cs
        selector: List[Bool] = []
        branch_counters: List[SlotCounters] = []
        for f, blk_ in cases:
            has_match = not_dummy.value and matched.value == f % self.p
            premise = alloc_bit(cs, has_match)
            implies_equal_const(cs, premise, matched, f)
            selector.append(premise)
            bc = counters.copy()
            self.synthesize_block(blk_, branch_outputs, premise, bc,
                                  dict(bound))
            branch_counters.append(bc)
        if default is not None:
            is_default_val = not_dummy.value and not any(
                b.value for b in selector)
            is_default = alloc_bit(cs, is_default_val)
            for f, _ in cases:
                implies_unequal_const(cs, is_default, matched, f)
            self.synthesize_block(default, branch_outputs, is_default,
                                  counters, dict(bound))
            selector.append(is_default)
        enforce_selector_with_premise(cs, not_dummy, selector)
        for bc in branch_counters:
            counters.max_with(bc)

    # -- ops ------------------------------------------------------------------

    def synthesize_op(self, op: ir.Op, not_dummy: Bool,
                      counters: SlotCounters, bound) -> None:
        cs = self.cs
        store = self.store
        k = op[0]
        g_num_tag = lambda: Num.constant(cs, int(ExprTag.Num))  # noqa: E731

        if k == ir.CALL:
            _, outs, func, ins = op
            concrete = (not self.ctx.blank) and not_dummy.value
            if concrete:
                output_hints = [self.ctx.hint_bindings[v] for v in outs]
            else:
                output_hints = [store.dummy()] * len(outs)
            args = [bound[v] for v in ins]
            out_ptrs = self.synthesize_func(func, args, not_dummy,
                                            counters, output_hints)
            for var, ptr in zip(outs, out_ptrs):
                bound[var] = ptr
        elif k == ir.CPROC:
            _, outs, sym_, ins = op
            synth = self.ctx.cproc_synthesizers.get(sym_)
            if synth is None:
                raise SynthesisError(
                    f"coprocessor {sym_} has no circuit synthesizer; "
                    "proving it would bind unconstrained advice")
            out_ptrs = synth.synthesize(self, not_dummy,
                                        [bound[v] for v in ins])
            assert len(out_ptrs) == len(outs)
            for var, ptr in zip(outs, out_ptrs):
                bound[var] = ptr
        elif k == ir.CROUT:
            _, outs, sym_, ins = op
            handler = self.ctx.crout_synthesizer
            if handler is None:
                raise SynthesisError(
                    f"coroutine {sym_} outside a memoset circuit scope")
            out_ptrs = handler(self, not_dummy, sym_,
                               [bound[v] for v in ins])
            if len(out_ptrs) != len(outs):
                raise SynthesisError(
                    f"coroutine {sym_} gave {len(out_ptrs)} outputs, "
                    f"expected {len(outs)}")
            for var, ptr in zip(outs, out_ptrs):
                bound[var] = ptr
        elif k in (ir.CONS2, ir.CONS3, ir.CONS4):
            st = {ir.CONS2: HASH4, ir.CONS3: HASH6, ir.CONS4: HASH8}[k]
            preimg, img_hash = self._slot(st, counters)
            ptrs = [bound[v] for v in op[3]]
            for i, aptr in enumerate(ptrs):
                implies_equal(cs, not_dummy, aptr.tag, preimg[2 * i])
                implies_equal(cs, not_dummy, aptr.hash, preimg[2 * i + 1])
            bound[op[1]] = AllocatedPtr(
                Num.constant(cs, op[2]), img_hash)
        elif k in (ir.DECONS2, ir.DECONS3, ir.DECONS4):
            st = {ir.DECONS2: HASH4, ir.DECONS3: HASH6,
                  ir.DECONS4: HASH8}[k]
            preimg, img_hash = self._slot(st, counters)
            img: AllocatedPtr = bound[op[2]]
            implies_equal(cs, not_dummy, img.hash, img_hash)
            for i, var in enumerate(op[1]):
                bound[var] = AllocatedPtr(preimg[2 * i], preimg[2 * i + 1])
        elif k == ir.PUSHBINDING:
            preimg, img_hash = self._slot(HASH4, counters)
            sym_p, val_p, env_p = (bound[v] for v in op[2])
            implies_equal_const(cs, not_dummy, sym_p.tag,
                                int(ExprTag.Sym))
            implies_equal(cs, not_dummy, sym_p.hash, preimg[0])
            implies_equal(cs, not_dummy, val_p.tag, preimg[1])
            implies_equal(cs, not_dummy, val_p.hash, preimg[2])
            implies_equal_const(cs, not_dummy, env_p.tag,
                                int(ExprTag.Env))
            implies_equal(cs, not_dummy, env_p.hash, preimg[3])
            bound[op[1]] = AllocatedPtr(
                Num.constant(cs, int(ExprTag.Env)), img_hash)
        elif k == ir.POPBINDING:
            preimg, img_hash = self._slot(HASH4, counters)
            img = bound[op[2]]
            implies_equal(cs, not_dummy, img.hash, img_hash)
            bound[op[1][0]] = AllocatedPtr(
                Num.constant(cs, int(ExprTag.Sym)), preimg[0])
            bound[op[1][1]] = AllocatedPtr(preimg[1], preimg[2])
            bound[op[1][2]] = AllocatedPtr(
                Num.constant(cs, int(ExprTag.Env)), preimg[3])
        elif k == ir.COPY:
            bound[op[1]] = bound[op[2]]
        elif k == ir.ZERO:
            bound[op[1]] = const_ptr(cs, op[2], 0)
        elif k == ir.HASH3ZEROS:
            bound[op[1]] = const_ptr(cs, op[2], store.hash3zeros)
        elif k == ir.HASH4ZEROS:
            bound[op[1]] = const_ptr(cs, op[2], store.hash4zeros)
        elif k == ir.HASH6ZEROS:
            bound[op[1]] = const_ptr(cs, op[2], store.hash6zeros)
        elif k == ir.HASH8ZEROS:
            bound[op[1]] = const_ptr(cs, op[2], store.hash8zeros)
        elif k == ir.LITOP:
            bound[op[1]] = self.const_for_ptr(self._lit_ptr(op[2]))
        elif k == ir.CAST:
            src: AllocatedPtr = bound[op[3]]
            bound[op[1]] = AllocatedPtr(Num.constant(cs, op[2]), src.hash)
        elif k == ir.EQTAG:
            a, b = bound[op[2]], bound[op[3]]
            bound[op[1]] = alloc_equal(cs, a.tag, b.tag)
        elif k == ir.EQVAL:
            a, b = bound[op[2]], bound[op[3]]
            bound[op[1]] = alloc_equal(cs, a.hash, b.hash)
        elif k == ir.NOT:
            bound[op[1]] = bound[op[2]].not_()
        elif k == ir.AND:
            bound[op[1]] = bool_and(cs, bound[op[2]], bound[op[3]])
        elif k == ir.OR:
            bound[op[1]] = bool_or(cs, bound[op[2]], bound[op[3]])
        elif k == ir.ADD:
            a, b = bound[op[2]], bound[op[3]]
            bound[op[1]] = AllocatedPtr(g_num_tag(),
                                        add(cs, a.hash, b.hash))
        elif k == ir.SUB:
            a, b = bound[op[2]], bound[op[3]]
            bound[op[1]] = AllocatedPtr(g_num_tag(),
                                        sub(cs, a.hash, b.hash))
        elif k == ir.MUL:
            a, b = bound[op[2]], bound[op[3]]
            bound[op[1]] = AllocatedPtr(g_num_tag(),
                                        mul(cs, a.hash, b.hash))
        elif k == ir.DIV:
            a, b = bound[op[2]], bound[op[3]]
            b_is_zero = alloc_is_zero(cs, b.hash)
            divisor = pick(cs, b_is_zero, Num.constant(cs, 1), b.hash)
            quotient = div(cs, a.hash, divisor)
            bound[op[1]] = AllocatedPtr(g_num_tag(), quotient)
        elif k == ir.LT:
            a, b = bound[op[2]], bound[op[3]]
            diff = sub(cs, a.hash, b.hash)
            double_a = add(cs, a.hash, a.hash)
            double_b = add(cs, b.hash, b.hash)
            double_diff = add(cs, diff, diff)
            slots = [self._slot(BIT_DECOMP, counters) for _ in range(3)]
            for dbl, (preimg, _) in zip(
                    (double_a, double_b, double_diff), slots):
                implies_equal(cs, not_dummy, dbl, preimg[0])
            a_neg = slots[0][1][0]
            b_neg = slots[1][1][0]
            diff_neg = slots[2][1][0]
            same_sign = bool_xor(cs, a_neg, b_neg).not_()
            and1 = bool_and(cs, same_sign, diff_neg)
            and2 = bool_and(cs, same_sign.not_(), a_neg)
            bound[op[1]] = bool_or(cs, and1, and2)
        elif k == ir.TRUNC:
            n = op[3]
            a = bound[op[2]]
            preimg, bits = self._slot(BIT_DECOMP, counters)
            implies_equal(cs, not_dummy, a.hash, preimg[0])
            trunc_bits = bits[:n]
            mask = (1 << n) - 1
            trunc_val = (a.hash.value & ((1 << 64) - 1)) & mask
            trunc = alloc_num(cs, trunc_val)
            implies_pack(cs, not_dummy, trunc_bits, trunc)
            bound[op[1]] = AllocatedPtr(g_num_tag(), trunc)
        elif k == ir.DIVREM64:
            a = bound[op[2]].hash
            b = bound[op[3]].hash
            if not_dummy.value:
                au = a.value & ((1 << 64) - 1)
                bu = b.value & ((1 << 64) - 1)
                dv, rv = (au // bu, au % bu) if bu else (0, au)
            else:
                dv, rv = 0, a.value
            d_num = alloc_num(cs, dv)
            r_num = alloc_num(cs, rv)
            diff = sub(cs, b, r_num)
            implies_u64(cs, not_dummy, d_num)
            implies_u64(cs, not_dummy, r_num)
            implies_u64(cs, not_dummy, diff)
            enforce_product_and_sum(cs, b, d_num, r_num, a)
            bound[op[1][0]] = AllocatedPtr(g_num_tag(), d_num)
            bound[op[1][1]] = AllocatedPtr(g_num_tag(), r_num)
        elif k == ir.EMIT:
            pass
        elif k == ir.RECV:
            var = op[1]
            ptr = self.ctx.hint_bindings.get(var)
            if ptr is None or self.ctx.blank:
                bound[var] = alloc_ptr(cs, 0, 0)
            else:
                z = store.hash_ptr(ptr)
                bound[var] = alloc_ptr(cs, z.tag, z.digest)
        elif k == ir.HIDE:
            preimg, img_hash = self._slot(COMMITMENT, counters)
            sec = bound[op[2]]
            pay = bound[op[3]]
            implies_equal_const(cs, not_dummy, sec.tag, int(ExprTag.Num))
            implies_equal(cs, not_dummy, sec.hash, preimg[0])
            implies_equal(cs, not_dummy, pay.tag, preimg[1])
            implies_equal(cs, not_dummy, pay.hash, preimg[2])
            bound[op[1]] = AllocatedPtr(
                Num.constant(cs, int(ExprTag.Comm)), img_hash)
        elif k == ir.OPEN:
            preimg, img_hash = self._slot(COMMITMENT, counters)
            comm: AllocatedPtr = bound[op[3]]
            implies_equal_const(cs, not_dummy, comm.tag,
                                int(ExprTag.Comm))
            implies_equal(cs, not_dummy, comm.hash, img_hash)
            bound[op[1]] = AllocatedPtr(
                Num.constant(cs, int(ExprTag.Num)), preimg[0])
            bound[op[2]] = AllocatedPtr(preimg[1], preimg[2])
        else:
            raise ValueError(f"cannot synthesize op {k}")


def synthesize_frame_with_inputs(
        cs: ConstraintSystem, func: ir.Func, store: Store, frame: Frame,
        inputs: List[AllocatedPtr],
        cproc_synthesizers: Optional[Dict] = None,
) -> List[AllocatedPtr]:
    """Synthesize one frame against pre-allocated input pointers; returns
    the output pointers. Used by MultiFrame chaining (the output of frame
    i IS the input of frame i+1 — shared allocations,
    multiframe.rs:596-712)."""
    slots: Dict[str, List[Slot]] = {}
    for st in SLOT_TYPES:
        datas = frame.hints.get(st)
        expected = func.slots_count.get(st)
        assert len(datas) == expected, \
            f"hints for {st}: {len(datas)} != {expected} slots"
        slots[st] = [allocate_slot(cs, d, st, store) for d in datas]
    ctx = SynthesisCtx(
        cs=cs, store=store, slots=slots, blank=frame.blank,
        hint_bindings=frame.hints.bindings,
        cproc_synthesizers=cproc_synthesizers or {},
    )
    synth = Synthesizer(ctx)
    return synth.synthesize_func(
        func, inputs, Bool.true(), SlotCounters(), frame.output)


def synthesize_frame(cs: ConstraintSystem, func: ir.Func, store: Store,
                     frame: Frame,
                     cproc_synthesizers: Optional[Dict] = None
                     ) -> Tuple[List[AllocatedPtr], List[AllocatedPtr]]:
    """Synthesize one frame, its inputs allocated as aux; returns
    (allocated inputs, outputs).

    Func::synthesize_frame parity (circuit.rs:1419-1475) minus the
    bellpepper plumbing. Hints must be padded (Interpreter.call does it).
    """
    inputs = []
    for ptr in frame.input:
        z = store.hash_ptr(ptr)
        inputs.append(alloc_ptr(cs, z.tag, z.digest))
    outputs = synthesize_frame_with_inputs(cs, func, store, frame, inputs,
                                           cproc_synthesizers)
    return inputs, outputs
