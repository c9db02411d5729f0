"""In-circuit elliptic-curve gadgets (complete projective arithmetic).

A copy of the JAX package's ``r1cs/ec_gadgets.py``.

Building blocks for the Nova augmented circuit: the fold verifier runs
INSIDE a circuit whose field equals the folded curve's BASE field (the
curve-cycle trick), so point arithmetic here is native field arithmetic.

Functionality parity target: arecibo's `gadgets::ecc::AllocatedPoint`
(external crate, driven by reference src/proof/nova.rs:40-71 via
the arecibo augmented circuit). Design difference (TPU-first, also
circuit-first): instead of arecibo's affine formulas with branchy
is-infinity case analysis (~40 constraints/add of selects), we use the
SAME complete projective formulas as the MSM's plain version
(``msm/kernel.py:ec_add``, Renes-Costello-Batina 2015 Alg 7, a=0):
one branchless formula, 12 multiplication constraints per add,
covering add/double/identity uniformly. Identity = (0, 1, 0).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..curves.weierstrass import Curve
from .cs import ConstraintSystem, lc_add, lc_scale, lc_sub
from .gadgets import (
    Bool, Num, alloc_is_zero, alloc_num, enforce_equal, mul, pick,
)


@dataclasses.dataclass
class AllocatedPoint:
    """Projective (X : Y : Z) over the circuit field = curve base field."""

    x: Num
    y: Num
    z: Num

    @staticmethod
    def identity(cs: ConstraintSystem) -> "AllocatedPoint":
        return AllocatedPoint(Num.constant(cs, 0), Num.constant(cs, 1),
                              Num.constant(cs, 0))

    @staticmethod
    def alloc_affine(cs: ConstraintSystem, pt) -> "AllocatedPoint":
        """Allocate from a host affine point (None = identity). The
        caller is responsible for constraining it to public data; use
        enforce_on_curve for group membership."""
        if pt is None:
            return AllocatedPoint(alloc_num(cs, 0), alloc_num(cs, 1),
                                  alloc_num(cs, 0))
        return AllocatedPoint(alloc_num(cs, pt[0]), alloc_num(cs, pt[1]),
                              alloc_num(cs, 1))

    def value(self, curve: Curve):
        """Host affine value (for witness plumbing)."""
        p = curve.p
        if self.z.value % p == 0:
            return None
        zinv = pow(self.z.value, -1, p)
        return (self.x.value * zinv % p, self.y.value * zinv % p)


def enforce_on_curve(cs: ConstraintSystem, curve: Curve,
                     pt: AllocatedPoint) -> None:
    """Y^2 Z = X^3 + b Z^3 (projective short Weierstrass, a=0) — holds
    for the identity (0,1,0) too."""
    y2 = mul(cs, pt.y, pt.y)
    y2z = mul(cs, y2, pt.z)
    x2 = mul(cs, pt.x, pt.x)
    x3 = mul(cs, x2, pt.x)
    z2 = mul(cs, pt.z, pt.z)
    z3 = mul(cs, z2, pt.z)
    bz3 = Num(lc_scale(z3.lc, curve.b % cs.p, cs.p),
              z3.value * curve.b % cs.p)
    rhs = Num(lc_add(x3.lc, bz3.lc, cs.p), (x3.value + bz3.value) % cs.p)
    enforce_equal(cs, y2z, rhs)


def _add_num(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    return Num(lc_add(a.lc, b.lc, cs.p), (a.value + b.value) % cs.p)


def _sub_num(cs: ConstraintSystem, a: Num, b: Num) -> Num:
    return Num(lc_sub(a.lc, b.lc, cs.p), (a.value - b.value) % cs.p)


def _scale(cs: ConstraintSystem, a: Num, k: int) -> Num:
    return Num(lc_scale(a.lc, k % cs.p, cs.p), a.value * k % cs.p)


def ec_add(cs: ConstraintSystem, curve: Curve, p1: AllocatedPoint,
           p2: AllocatedPoint) -> AllocatedPoint:
    """Complete projective add — the exact mul/add sequence of
    msm/kernel.py:ec_add (RCB15 Alg 7, a=0); 12 constraints."""
    b3 = 3 * curve.b
    x1, y1, z1 = p1.x, p1.y, p1.z
    x2, y2, z2 = p2.x, p2.y, p2.z
    t0 = mul(cs, x1, x2)
    t1 = mul(cs, y1, y2)
    t2 = mul(cs, z1, z2)
    t3 = _add_num(cs, x1, y1)
    t4 = _add_num(cs, x2, y2)
    t3 = mul(cs, t3, t4)
    t4 = _add_num(cs, t0, t1)
    t3 = _sub_num(cs, t3, t4)
    t4 = _add_num(cs, y1, z1)
    x3 = _add_num(cs, y2, z2)
    t4 = mul(cs, t4, x3)
    x3 = _add_num(cs, t1, t2)
    t4 = _sub_num(cs, t4, x3)
    x3 = _add_num(cs, x1, z1)
    y3 = _add_num(cs, x2, z2)
    x3 = mul(cs, x3, y3)
    y3 = _add_num(cs, t0, t2)
    y3 = _sub_num(cs, x3, y3)
    x3 = _add_num(cs, t0, t0)
    t0 = _add_num(cs, x3, t0)
    t2 = _scale(cs, t2, b3)
    z3 = _add_num(cs, t1, t2)
    t1 = _sub_num(cs, t1, t2)
    y3 = _scale(cs, y3, b3)
    x3 = mul(cs, t4, y3)
    t2 = mul(cs, t3, t1)
    x3 = _sub_num(cs, t2, x3)
    y3 = mul(cs, y3, t0)
    t1 = mul(cs, t1, z3)
    y3 = _add_num(cs, t1, y3)
    t0 = mul(cs, t0, t3)
    z3 = mul(cs, z3, t4)
    z3 = _add_num(cs, z3, t0)
    return AllocatedPoint(x3, y3, z3)


def ec_select(cs: ConstraintSystem, cond: Bool, a: AllocatedPoint,
              b: AllocatedPoint) -> AllocatedPoint:
    """cond ? a : b (3 constraints)."""
    return AllocatedPoint(pick(cs, cond, a.x, b.x),
                          pick(cs, cond, a.y, b.y),
                          pick(cs, cond, a.z, b.z))


def ec_scalar_mul(cs: ConstraintSystem, curve: Curve,
                  bits_le: List[Bool],
                  base: AllocatedPoint) -> AllocatedPoint:
    """[k] base for k = sum bits_le[i] 2^i (double-and-add MSB-first;
    the complete add doubles correctly, so one formula serves both)."""
    acc = AllocatedPoint.identity(cs)
    for bit in reversed(bits_le):
        acc = ec_add(cs, curve, acc, acc)
        added = ec_add(cs, curve, acc, base)
        acc = ec_select(cs, bit, added, acc)
    return acc


def ec_normalize(cs: ConstraintSystem, curve: Curve, pt: AllocatedPoint
                 ) -> Tuple[Num, Num, Bool]:
    """(x_affine, y_affine, is_identity); identity normalizes to (0, 0).

    zinv is advice: z * zinv = 1 - is_id and z * is_id = 0 pin it."""
    p = cs.p
    is_id = alloc_is_zero(cs, pt.z)
    zv = pt.z.value % p
    zinv = alloc_num(cs, 0 if zv == 0 else pow(zv, -1, p))
    one = {ConstraintSystem.ONE_VAR: 1}
    cs.enforce(pt.z.lc, zinv.lc, lc_sub(one, is_id.num.lc, p))
    x_aff = mul(cs, pt.x, zinv)
    y_aff = mul(cs, pt.y, zinv)
    return x_aff, y_aff, is_id
