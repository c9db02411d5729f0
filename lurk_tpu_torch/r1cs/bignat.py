"""Nonnative field arithmetic gadgets (the other field of the cycle).

A copy of the JAX package's ``r1cs/bignat.py``.

The Nova augmented circuit over F1 folds instances of the circuit over
F2 (and vice versa): commitments are native group ops (ec_gadgets), but
the instance SCALARS (u, X) live in F2 and must be folded mod p2 inside
the F1 circuit. This module provides the minimal nonnative gadget set:

    u' = (u + r)        mod p2      (bignat_add_challenge)
    x' = (x + r * x2)   mod p2      (bignat_mul_add_challenge)

with r the 124-bit Fiat-Shamir challenge (transcript.CHALLENGE_BITS —
small enough that every intermediate field value below stays < 2^191,
far under all cycle moduli, so the grouped carry equations hold over
the integers).

Design: 4 x 64-bit little-endian limbs, always CANONICAL (< p2, enforced
at allocation). Products r*limb stay unsplit "wide coefficients"
(< 2^188); a carry chain with shifted, range-checked carries proves the
integer identity x + r*x2 = qt*p2 + x'. This replaces the bellman-bignat
machinery arecibo uses in its augmented circuit (external crate; driven
by reference src/proof/nova.rs).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .cs import ConstraintSystem, lc_add, lc_scale, lc_sub
from .gadgets import (
    Bool, Num, alloc_bit, kary_and, mul, pick,
)

W = 64          # limb bits
K = 4           # limbs (covers < 2^256; cycle moduli are < 2^255)
CARRY_SHIFT = 1 << 126   # carries c_j in (-2^126, 2^126); t = c + shift


def enforce_leq_const(cs: ConstraintSystem, bits: List[Bool],
                      m: int) -> None:
    """Enforce sum(bits[i] 2^i) <= m (MSB-first run comparison, the
    field_into_allocated_bits_le_strict pattern generalized to any
    bound)."""
    last_run = Bool.true()
    current_run: List[Bool] = []
    for i in range(len(bits) - 1, -1, -1):
        if (m >> i) & 1:
            current_run.append(bits[i])
        else:
            if current_run:
                last_run = kary_and(cs, [last_run] + current_run)
                current_run = []
            # last_run -> bits[i] == 0
            cs.enforce(last_run.lc(cs), bits[i].lc(cs), {})


def alloc_ranged(cs: ConstraintSystem, value: int, n_bits: int) -> Num:
    """Allocate `value` as n_bits booleans; the returned Num is their
    (free) linear packing — range [0, 2^n_bits) enforced."""
    assert 0 <= value < (1 << n_bits), "range witness out of bounds"
    lc = {}
    for i in range(n_bits):
        b = alloc_bit(cs, bool((value >> i) & 1))
        lc = lc_add(lc, lc_scale(b.lc(cs), 1 << i, cs.p), cs.p)
    return Num(lc, value % cs.p)


@dataclasses.dataclass
class BigNat:
    """Canonical nonnative element: K x W-bit limbs + its python value."""

    limbs: List[Num]
    value: int

    def lo_hi(self) -> Tuple[Num, Num]:
        """(low 128 bits, high bits) as free LCs — matches the host
        transcript's absorb_scalar limb split (used when this bignat's
        modulus EXCEEDS the circuit field)."""
        return (_pack2(self.limbs[0], self.limbs[1]),
                _pack2(self.limbs[2], self.limbs[3]))

    def packed(self, cs: ConstraintSystem) -> Num:
        """The full value as one circuit-field LC (only valid when this
        bignat's modulus is BELOW the circuit field — the host
        transcript then absorbs the scalar whole)."""
        lo, hi = self.lo_hi()
        lc = dict(lo.lc)
        for k, v in hi.lc.items():
            lc[k] = (lc.get(k, 0) + (v << 128)) % cs.p
        return Num({k: v % cs.p for k, v in lc.items()},
                   (lo.value + (hi.value << 128)) % cs.p)


def _pack2(a: Num, b: Num) -> Num:
    # a + 2^W * b as an LC (no allocation); p taken from coefficient use
    lc = dict(a.lc)
    for k, v in b.lc.items():
        lc[k] = lc.get(k, 0) + (v << W)
    return Num(lc, a.value + (b.value << W))


def _limbs_of(v: int) -> List[int]:
    return [(v >> (W * j)) & ((1 << W) - 1) for j in range(K)]


def alloc_bignat(cs: ConstraintSystem, value: int, modulus: int) -> BigNat:
    """Allocate a canonical (< modulus) nonnative element: 64-bit range
    check per limb + a global <= modulus-1 bit comparison."""
    value %= modulus
    all_bits: List[Bool] = []
    limbs = []
    for lv in _limbs_of(value):
        lc = {}
        for i in range(W):
            b = alloc_bit(cs, bool((lv >> i) & 1))
            all_bits.append(b)
            lc = lc_add(lc, lc_scale(b.lc(cs), 1 << i, cs.p), cs.p)
        limbs.append(Num(lc, lv % cs.p))
    enforce_leq_const(cs, all_bits, modulus - 1)
    return BigNat(limbs, value)


def bignat_zero(cs: ConstraintSystem) -> BigNat:
    z = Num.constant(cs, 0)
    return BigNat([z, z, z, z], 0)


def bignat_constant(cs: ConstraintSystem, value: int) -> BigNat:
    return BigNat([Num.constant(cs, lv) for lv in _limbs_of(value)], value)


def bignat_enforce_equal(cs: ConstraintSystem, a: BigNat,
                         b: BigNat) -> None:
    one = {ConstraintSystem.ONE_VAR: 1}
    for la, lb in zip(a.limbs, b.limbs):
        cs.enforce(lc_sub(la.lc, lb.lc, cs.p), one, {})


def bignat_select(cs: ConstraintSystem, cond: Bool, a: BigNat,
                  b: BigNat) -> BigNat:
    limbs = [pick(cs, cond, la, lb) for la, lb in zip(a.limbs, b.limbs)]
    return BigNat(limbs, a.value if cond.value else b.value)


def bignat_add_challenge(cs: ConstraintSystem, a: BigNat, r: Num,
                         r_int: int, modulus: int) -> BigNat:
    """(a + r) mod modulus, r < 2^CHALLENGE_BITS. One conditional
    subtraction: a + r = out + b*modulus with b boolean."""
    p = cs.p
    one = {ConstraintSystem.ONE_VAR: 1}
    total = a.value + r_int
    b_val = total >= modulus
    out = alloc_bignat(cs, total % modulus, modulus)
    b = alloc_bit(cs, b_val)
    m_limbs = _limbs_of(modulus)
    # grouped carry equations; r (< 2^124) enters whole as a group-0
    # wide coefficient, well inside the 2^189 budget.
    plus_ints = [a_limb + (r_int if j == 0 else 0)
                 for j, a_limb in enumerate(_limbs_of(a.value))]
    minus_ints = [ol + (m_limbs[j] if b_val else 0)
                  for j, ol in enumerate(_limbs_of(out.value))]
    t_prev: Num | None = None
    t_prev_int = 0
    for j in range(K):
        lhs_int = plus_ints[j] + (t_prev_int - CARRY_SHIFT
                                  if t_prev is not None else 0)
        rhs_base = minus_ints[j]
        lhs_lc = dict(a.limbs[j].lc)
        if j == 0:
            lhs_lc = lc_add(lhs_lc, r.lc, p)
        if t_prev is not None:
            lhs_lc = lc_add(lhs_lc, t_prev.lc, p)
        rhs_lc = dict(out.limbs[j].lc)
        rhs_lc = lc_add(rhs_lc, lc_scale(b.lc(cs), m_limbs[j], p), p)
        if t_prev is not None:
            rhs_lc = lc_add(rhs_lc, {ConstraintSystem.ONE_VAR: CARRY_SHIFT},
                            p)
        if j < K - 1:
            diff = lhs_int - rhs_base
            assert diff % (1 << W) == 0, "carry chain misalignment"
            c = diff >> W
            assert abs(c) < CARRY_SHIFT, "carry out of range"
            t = alloc_ranged(cs, c + CARRY_SHIFT, 127)
            # t embeds the +CARRY_SHIFT; cancel its 2^W-weighted copy
            lhs_lc = lc_add(
                lhs_lc, {ConstraintSystem.ONE_VAR: CARRY_SHIFT << W}, p)
            rhs_lc = lc_add(rhs_lc, lc_scale(t.lc, 1 << W, p), p)
            cs.enforce(lc_sub(lhs_lc, rhs_lc, p), one, {})
            t_prev, t_prev_int = t, c + CARRY_SHIFT
        else:
            assert lhs_int == rhs_base, "top group must balance"
            cs.enforce(lc_sub(lhs_lc, rhs_lc, p), one, {})
    return out


def bignat_mul_add_challenge(cs: ConstraintSystem, a: BigNat, b: BigNat,
                             r: Num, r_int: int, modulus: int) -> BigNat:
    """(a + r * b) mod modulus, r < 2^CHALLENGE_BITS.

    Products r*b_j are wide coefficients (< 2^188); the integer identity
    a + r*b = qt*modulus + out is proven by the grouped carry chain."""
    p = cs.p
    one = {ConstraintSystem.ONE_VAR: 1}
    total = a.value + r_int * b.value
    qt_int, out_int = divmod(total, modulus)
    assert qt_int < (1 << 125)
    out = alloc_bignat(cs, out_int, modulus)
    qt = alloc_ranged(cs, qt_int, 125)
    m_limbs = _limbs_of(modulus)
    # wide products (constraint each)
    prods = [mul(cs, r, b.limbs[j]) for j in range(K)]
    prod_ints = [r_int * lb for lb in _limbs_of(b.value)]
    a_ints = _limbs_of(a.value)
    o_ints = _limbs_of(out_int)
    t_prev: Num | None = None
    t_prev_int = 0
    for j in range(K):
        lhs_int = a_ints[j] + prod_ints[j] + \
            (t_prev_int - CARRY_SHIFT if t_prev is not None else 0)
        rhs_int = o_ints[j] + qt_int * m_limbs[j]
        lhs_lc = lc_add(a.limbs[j].lc, prods[j].lc, p)
        if t_prev is not None:
            lhs_lc = lc_add(lhs_lc, t_prev.lc, p)
        rhs_lc = lc_add(out.limbs[j].lc,
                        lc_scale(qt.lc, m_limbs[j], p), p)
        if t_prev is not None:
            rhs_lc = lc_add(rhs_lc,
                            {ConstraintSystem.ONE_VAR: CARRY_SHIFT}, p)
        if j < K - 1:
            diff = lhs_int - rhs_int
            assert diff % (1 << W) == 0, "carry chain misalignment"
            c = diff >> W
            assert abs(c) < CARRY_SHIFT, "carry out of range"
            t = alloc_ranged(cs, c + CARRY_SHIFT, 127)
            # t embeds the +CARRY_SHIFT; cancel its 2^W-weighted copy
            lhs_lc = lc_add(
                lhs_lc, {ConstraintSystem.ONE_VAR: CARRY_SHIFT << W}, p)
            rhs_lc = lc_add(rhs_lc, lc_scale(t.lc, 1 << W, p), p)
            cs.enforce(lc_sub(lhs_lc, rhs_lc, p), one, {})
            t_prev, t_prev_int = t, c + CARRY_SHIFT
        else:
            assert lhs_int == rhs_int, "top group must balance"
            cs.enforce(lc_sub(lhs_lc, rhs_lc, p), one, {})
    return out
