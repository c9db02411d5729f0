"""R1CS gadget library: booleans, arithmetic, implications, bit packing.

A copy of the JAX package's ``r1cs/gadgets.py``. Semantics parity with
the reference's bellpepper helpers (reference
src/circuit/gadgets/constraints.rs:14-807) re-implemented against
:mod:`lurk_tpu_torch.r1cs.cs`. Constraint counts may differ from
bellpepper where an equivalent cheaper formulation exists; circuit
uniformity (identical shape for every witness) is preserved everywhere —
allocation paths never depend on values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .cs import LC, ConstraintSystem, lc_add, lc_scale, lc_sub


@dataclasses.dataclass
class Num:
    """An assigned value together with its linear combination."""

    lc: LC
    value: int

    @staticmethod
    def constant(cs: ConstraintSystem, v: int) -> "Num":
        v %= cs.p
        return Num({ConstraintSystem.ONE_VAR: v} if v else {}, v)


def alloc_num(cs: ConstraintSystem, value: int) -> Num:
    var = cs.alloc(value)
    if cs.witness_only:
        # LCs are never consumed without constraints; empty LCs make all
        # downstream linear algebra free (WitnessCS parity)
        return Num({}, value % cs.p)
    return Num({var: 1}, value % cs.p)


def alloc_input_num(cs: ConstraintSystem, value: int) -> Num:
    var = cs.alloc_input(value)
    if cs.witness_only:
        return Num({}, value % cs.p)
    return Num({var: 1}, value % cs.p)


@dataclasses.dataclass
class Bool:
    """Boolean: constant, allocated bit, or its negation (free)."""

    num: Optional[Num]        # None => constant
    negated: bool = False
    const_val: bool = False

    @property
    def value(self) -> bool:
        if self.num is None:
            return self.const_val
        v = bool(self.num.value)
        return (not v) if self.negated else v

    def lc(self, cs: ConstraintSystem) -> LC:
        one = {ConstraintSystem.ONE_VAR: 1}
        if self.num is None:
            return one if self.const_val else {}
        if self.negated:
            return lc_sub(one, self.num.lc, cs.p)
        return dict(self.num.lc)

    def not_(self) -> "Bool":
        if self.num is None:
            return Bool(None, const_val=not self.const_val)
        return Bool(self.num, negated=not self.negated)

    @staticmethod
    def true() -> "Bool":
        return Bool(None, const_val=True)

    @staticmethod
    def false() -> "Bool":
        return Bool(None, const_val=False)


def alloc_bit(cs: ConstraintSystem, value: bool) -> Bool:
    """Allocated bit with booleanity constraint bit*(1-bit)=0."""
    n = alloc_num(cs, 1 if value else 0)
    one = {ConstraintSystem.ONE_VAR: 1}
    cs.enforce(n.lc, lc_sub(one, n.lc, cs.p), {})
    return Bool(n)


# -- arithmetic over Nums ----------------------------------------------------


def add(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    """Allocated sum with (a+b)*1 = c (AllocatedNum::add parity)."""
    c = alloc_num(cs, (a.value + b.value) % cs.p)
    cs.enforce(lc_add(a.lc, b.lc, cs.p), {ConstraintSystem.ONE_VAR: 1}, c.lc)
    return c


def sub(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    c = alloc_num(cs, (a.value - b.value) % cs.p)
    cs.enforce(lc_add(c.lc, b.lc, cs.p), {ConstraintSystem.ONE_VAR: 1}, a.lc)
    return c


def mul(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    c = alloc_num(cs, (a.value * b.value) % cs.p)
    cs.enforce(a.lc, b.lc, c.lc)
    return c


def div(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    """Quotient q with q*b = a. Caller guarantees b != 0."""
    inv = pow(b.value, cs.p - 2, cs.p) if b.value else 0
    q = alloc_num(cs, (a.value * inv) % cs.p)
    cs.enforce(q.lc, b.lc, a.lc)
    return q


def enforce_equal(cs: ConstraintSystem, a: Num, b: Num) -> None:
    cs.enforce(lc_sub(a.lc, b.lc, cs.p), {ConstraintSystem.ONE_VAR: 1}, {})


def pick(cs: ConstraintSystem, cond: Bool, a: Num, b: Num) -> Num:
    """cond ? a : b — allocated result; cond*(a-b) = r-b."""
    r = alloc_num(cs, a.value if cond.value else b.value)
    cs.enforce(cond.lc(cs), lc_sub(a.lc, b.lc, cs.p),
               lc_sub(r.lc, b.lc, cs.p))
    return r


# -- equality / zero tests ----------------------------------------------------


def alloc_is_zero(cs: ConstraintSystem, x: Num) -> Bool:
    """Boolean x == 0: aux inv, constraints x*inv = 1-r and x*r = 0."""
    is_zero = x.value % cs.p == 0
    r = alloc_bit(cs, is_zero)
    inv = alloc_num(cs, 0 if is_zero else pow(x.value, cs.p - 2, cs.p))
    one = {ConstraintSystem.ONE_VAR: 1}
    cs.enforce(x.lc, inv.lc, lc_sub(one, r.num.lc, cs.p))
    cs.enforce(x.lc, r.num.lc, {})
    return r


def alloc_equal(cs: ConstraintSystem, a: Num, b: Num) -> Bool:
    diff = Num(lc_sub(a.lc, b.lc, cs.p), (a.value - b.value) % cs.p)
    return alloc_is_zero(cs, diff)


# -- implications --------------------------------------------------------------


def implies_equal(cs: ConstraintSystem, premise: Bool, a: Num,
                  b: Num) -> None:
    cs.enforce(premise.lc(cs), lc_sub(a.lc, b.lc, cs.p), {})


def implies_equal_const(cs: ConstraintSystem, premise: Bool, a: Num,
                        c: int) -> None:
    const = {ConstraintSystem.ONE_VAR: c % cs.p} if c % cs.p else {}
    cs.enforce(premise.lc(cs), lc_sub(a.lc, const, cs.p), {})


def implies_unequal_const(cs: ConstraintSystem, premise: Bool, a: Num,
                          c: int) -> None:
    """premise -> a != c, via q*(a-c) = premise."""
    diff = (a.value - c) % cs.p
    qv = pow(diff, cs.p - 2, cs.p) if (premise.value and diff) else 0
    q = alloc_num(cs, qv)
    const = {ConstraintSystem.ONE_VAR: c % cs.p} if c % cs.p else {}
    cs.enforce(q.lc, lc_sub(a.lc, const, cs.p), premise.lc(cs))


def implies_pack(cs: ConstraintSystem, premise: Bool,
                 bits: Sequence[Bool], num: Num) -> None:
    """premise -> num == sum 2^i bits[i]."""
    pack: LC = {}
    coeff = 1
    for b in bits:
        pack = lc_add(pack, lc_scale(b.lc(cs), coeff, cs.p), cs.p)
        coeff = (coeff * 2) % cs.p
    cs.enforce(lc_sub(pack, num.lc, cs.p), premise.lc(cs), {})


def implies_u64(cs: ConstraintSystem, premise: Bool, a: Num) -> None:
    """premise -> a fits in 64 bits (constraints.rs:131-154)."""
    a_u64 = a.value & ((1 << 64) - 1)
    bits = []
    for i in range(64):
        bits.append(alloc_bit(cs, bool((a_u64 >> i) & 1)))
    implies_pack(cs, premise, bits, a)


def enforce_selector_with_premise(cs: ConstraintSystem, premise: Bool,
                                  selector: Sequence[Bool]) -> None:
    """premise -> exactly one of selector is true (sum == 1)."""
    acc: LC = {}
    for b in selector:
        acc = lc_add(acc, b.lc(cs), cs.p)
    one = {ConstraintSystem.ONE_VAR: 1}
    cs.enforce(premise.lc(cs), lc_sub(acc, one, cs.p), {})


def enforce_product_and_sum(cs: ConstraintSystem, a: Num, b: Num,
                            c: Num, d: Num) -> None:
    """a*b + c = d as a single constraint a*b = d - c."""
    cs.enforce(a.lc, b.lc, lc_sub(d.lc, c.lc, cs.p))


# -- boolean ops ----------------------------------------------------------------


def bool_and(cs: ConstraintSystem, a: Bool, b: Bool) -> Bool:
    """bellpepper AllocatedBit::and parity: ONE constraint a*b = r.
    r's booleanity is implied by the inputs' (no extra constraint)."""
    if a.num is None:
        return b if a.const_val else Bool.false()
    if b.num is None:
        return a if b.const_val else Bool.false()
    r = alloc_num(cs, 1 if (a.value and b.value) else 0)
    cs.enforce(a.lc(cs), b.lc(cs), r.lc)
    return Bool(r)


def bool_or(cs: ConstraintSystem, a: Bool, b: Bool) -> Bool:
    if a.num is None:
        return Bool.true() if a.const_val else b
    if b.num is None:
        return Bool.true() if b.const_val else a
    return bool_and(cs, a.not_(), b.not_()).not_()


def bool_xor(cs: ConstraintSystem, a: Bool, b: Bool) -> Bool:
    if a.num is None:
        return b if not a.const_val else b.not_()
    if b.num is None:
        return a if not b.const_val else a.not_()
    r = alloc_bit(cs, a.value != b.value)
    # 2a * b = a + b - r
    cs.enforce(lc_scale(a.lc(cs), 2, cs.p), b.lc(cs),
               lc_sub(lc_add(a.lc(cs), b.lc(cs), cs.p), r.num.lc, cs.p))
    return r


def kary_and(cs: ConstraintSystem, bits: List[Bool]) -> Bool:
    assert bits
    acc = bits[0]
    for b in bits[1:]:
        acc = bool_and(cs, acc, b)
    return acc


# -- bit decomposition -----------------------------------------------------------


def alloc_bit_conditionally(cs: ConstraintSystem, value: bool,
                            must_be_false: Bool) -> Bool:
    """bellpepper AllocatedBit::alloc_conditionally: ONE constraint
    (1 - mbf - a) * a = 0 fuses booleanity with mbf -> a = 0."""
    n = alloc_num(cs, 1 if value else 0)
    one = {ConstraintSystem.ONE_VAR: 1}
    lc = lc_sub(lc_sub(one, must_be_false.lc(cs), cs.p), n.lc, cs.p)
    cs.enforce(lc, n.lc, {})
    return Bool(n)


def to_bits_le_strict(cs: ConstraintSystem, num: Num) -> List[Bool]:
    """Strict little-endian bit decomposition at bellpepper's exact
    constraint cost (field_into_allocated_bits_le_strict + pack):
    1-bits of m = p-1 get plain boolean allocs feeding a running kary
    AND (``last_run``); 0-bits use the fused alloc_conditionally
    constraint (booleanity AND ``last_run -> bit = 0`` in one row);
    plus one packing constraint. BN256: 354 constraints — matching the
    reference's empirical bit_decomp_cost table
    (reference src/lem/circuit.rs:1708-1714; slot synthesis at
    circuit.rs:241)."""
    p = cs.p
    n_bits = cs.field.num_bits
    v = num.value % p
    m = p - 1
    bits_msb: List[Bool] = []
    last_run: Optional[Bool] = None     # None => constant true
    current_run: List[Bool] = []
    for i in range(n_bits - 1, -1, -1):
        bval = bool((v >> i) & 1)
        if (m >> i) & 1:
            b = alloc_bit(cs, bval)
            current_run.append(b)
        else:
            if current_run:
                if last_run is not None:
                    current_run.insert(0, last_run)
                last_run = kary_and(cs, current_run)
                current_run = []
            if last_run is None:
                # m's MSB is 1 for every supported field, so a 0-bit
                # before any run is unreachable; keep it sound anyway
                b = alloc_bit(cs, bval)
                assert not bval or v <= m
            else:
                b = alloc_bit_conditionally(cs, bval, last_run)
        bits_msb.append(b)
    bits = bits_msb[::-1]

    # packing: sum 2^i bits[i] == num
    pack: LC = {}
    coeff = 1
    for b in bits:
        pack = lc_add(pack, lc_scale(b.lc(cs), coeff, p), p)
        coeff = (coeff * 2) % p
    cs.enforce(pack, {ConstraintSystem.ONE_VAR: 1}, num.lc)
    return bits
