"""Host (python-int) short-Weierstrass curve arithmetic: Pallas, Vesta,
BN254 G1 and Grumpkin.

A copy of the JAX package's ``lurk_tpu/curves/weierstrass.py``: the
bit-exactness oracle for the port's MSM kernel (``msm/kernel.py``,
``csrc/msm.cu``). Replaces the reference's external `pasta_curves`
crate (reference Cargo.toml:137; used for Nova/SuperNova commitments
via arecibo).

Curve equations (pasta spec): y^2 = x^3 + 5 over the respective base
fields; both curves have prime order and form a 2-cycle:
Pallas base field = Vesta scalar field and vice versa. Generator (-1, 2)
per pasta_curves.

Differences from the copy's source: :meth:`Curve.derive_generators_from`
routes ranges of 64 or more to the port's host C++
(``csrc/host/pedersen.cpp``) and raises if it cannot be built;
:meth:`Curve.pippenger` is the Python path only (the port's copy of
the JAX package's ``native/msm.cpp`` is ``hostlib/msm.py``, a CPU
commitment key's route; a CUDA key commits through the MSM kernel).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

from ..fields import (
    BN256_SCALAR, FieldSpec, GRUMPKIN_SCALAR, PALLAS_SCALAR, VESTA_SCALAR,
)

# Affine point: (x, y) or None for infinity
Affine = Optional[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Curve:
    name: str
    base: FieldSpec     # coordinate field
    scalar: FieldSpec   # group order field
    b: int = 5
    gen: Optional[Tuple[int, int]] = None   # None -> (-1, 2) (pasta)

    @property
    def p(self) -> int:
        return self.base.modulus

    @property
    def order(self) -> int:
        return self.scalar.modulus

    @property
    def generator(self) -> Affine:
        if self.gen is not None:
            return self.gen
        return (self.p - 1, 2)

    # -- affine group law --------------------------------------------------

    def is_on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.b)) % self.p == 0

    def neg(self, pt: Affine) -> Affine:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def add(self, a: Affine, b: Affine) -> Affine:
        p = self.p
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            # doubling
            lam = (3 * x1 * x1) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def double(self, a: Affine) -> Affine:
        return self.add(a, a)

    def mul(self, k: int, pt: Affine) -> Affine:
        """Scalar mul via a Jacobian double-and-add ladder (one field
        inversion total; the affine ladder costs one inversion PER add,
        ~30x slower — the IPA generator folds do 2n of these)."""
        k %= self.order
        if pt is None or k == 0:
            return None
        acc = (0, 1, 0)
        base = self.jac_from_affine(pt)
        while k:
            if k & 1:
                acc = self.jac_add(acc, base)
            base = self.jac_double(base)
            k >>= 1
        return self.jac_to_affine(acc)

    def msm(self, scalars: List[int], points: List[Affine]) -> Affine:
        """Reference MSM (naive; oracle for the Pippenger paths)."""
        acc: Affine = None
        for k, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(k, pt))
        return acc

    # -- Jacobian ops (host hot path: no per-add field inversion) -----------

    def jac_add(self, a, b):
        """Jacobian add; points (X, Y, Z) with Z=0 for infinity."""
        p = self.p
        if a[2] == 0:
            return b
        if b[2] == 0:
            return a
        x1, y1, z1 = a
        x2, y2, z2 = b
        z1z1 = z1 * z1 % p
        z2z2 = z2 * z2 % p
        u1 = x1 * z2z2 % p
        u2 = x2 * z1z1 % p
        s1 = y1 * z2 * z2z2 % p
        s2 = y2 * z1 * z1z1 % p
        if u1 == u2:
            if s1 != s2:
                return (0, 1, 0)
            return self.jac_double(a)
        h = (u2 - u1) % p
        i = (2 * h) ** 2 % p
        j = h * i % p
        r = 2 * (s2 - s1) % p
        v = u1 * i % p
        x3 = (r * r - j - 2 * v) % p
        y3 = (r * (v - x3) - 2 * s1 * j) % p
        z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) % p * h % p
        return (x3, y3, z3)

    def jac_double(self, a):
        p = self.p
        if a[2] == 0:
            return a
        x1, y1, z1 = a
        aa = x1 * x1 % p
        b = y1 * y1 % p
        c = b * b % p
        d = 2 * ((x1 + b) ** 2 - aa - c) % p
        e = 3 * aa % p
        f = e * e % p
        x3 = (f - 2 * d) % p
        y3 = (e * (d - x3) - 8 * c) % p
        z3 = 2 * y1 * z1 % p
        return (x3, y3, z3)

    def jac_from_affine(self, pt: Affine):
        if pt is None:
            return (0, 1, 0)
        return (pt[0], pt[1], 1)

    def jac_to_affine(self, a) -> Affine:
        if a[2] == 0:
            return None
        p = self.p
        zinv = pow(a[2], p - 2, p)
        zinv2 = zinv * zinv % p
        return (a[0] * zinv2 % p, a[1] * zinv2 * zinv % p)

    def pippenger(self, scalars: List[int], points: List[Affine],
                  c: int = 8) -> Affine:
        """Host Pippenger in Jacobian coordinates (Python ints): the
        oracle of the MSM kernel, and the route of commits too small for
        the card."""
        if not scalars:
            return None
        n_windows = (self.scalar.num_bits + c - 1) // c
        jpoints = [self.jac_from_affine(pt) for pt in points]
        mask = (1 << c) - 1
        acc = (0, 1, 0)
        for w in range(n_windows - 1, -1, -1):
            for _ in range(c):
                acc = self.jac_double(acc)
            buckets = [(0, 1, 0)] * (mask + 1)
            for s, pt in zip(scalars, jpoints):
                d = (s >> (c * w)) & mask
                if d:
                    buckets[d] = self.jac_add(buckets[d], pt)
            run = (0, 1, 0)
            total = (0, 1, 0)
            for d in range(mask, 0, -1):
                run = self.jac_add(run, buckets[d])
                total = self.jac_add(total, run)
            acc = self.jac_add(acc, total)
        return self.jac_to_affine(acc)

    # -- point (de)serialization -------------------------------------------

    def sqrt(self, a: int) -> Optional[int]:
        """Square root mod p (both pasta primes are p ≡ 1 mod 4; use
        Tonelli-Shanks)."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        # Tonelli-Shanks
        q = p - 1
        s = 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            bexp = pow(c, 1 << (m - i - 1), p)
            m, c = i, bexp * bexp % p
            t = t * c % p
            r = r * bexp % p
        return r

    def point_from_x(self, x: int, y_is_odd: bool) -> Affine:
        y2 = (x * x * x + self.b) % self.p
        y = self.sqrt(y2)
        if y is None:
            return None
        if y == 0:
            # unreachable in practice; an odd-parity request on y=0 is
            # a rejection (matches csrc/host/pedersen.cpp)
            return (x, 0) if not y_is_odd else None
        if (y & 1) != int(y_is_odd):
            y = self.p - y
        return (x, y)

    # -- deterministic generator derivation ----------------------------------

    def derive_generators(self, label: bytes, n: int) -> List[Affine]:
        """Deterministic hash-derived generators for the Pedersen
        commitment key.

        NOTE: the reference's arecibo derives its commitment key with
        `from_label` + pasta hash-to-curve (external crate, no vectors
        available offline); this uses a documented try-and-increment over
        shake256 output instead. Self-consistent across prove/verify;
        revisit if arecibo vectors become available.
        """
        return self.derive_generators_from(label, 0, n)

    def derive_generators_from(self, label: bytes, start: int,
                               end: int) -> List[Affine]:
        """Generators for indices [start, end) — per-index rejection
        sampling so the sequence is extendable (params cache growth).
        Ranges of 64 or more go to the threaded host C++
        (csrc/host/pedersen.cpp, bit-exact), which raises if it cannot
        be built; shorter ones run the Python path below."""
        if end - start >= 64:
            from ..hostlib import pedersen
            return pedersen.derive_generators_from(self, label, start, end)
        out: List[Affine] = []
        for i in range(start, end):
            for attempt in range(256):
                h = hashlib.shake_256(
                    label + i.to_bytes(8, "little")
                    + attempt.to_bytes(8, "little")).digest(33)
                x = int.from_bytes(h[:32], "little") % self.p
                pt = self.point_from_x(x, bool(h[32] & 1))
                if pt is not None:
                    out.append(pt)
                    break
            else:
                raise RuntimeError("generator derivation failed")
        return out


PALLAS = Curve("pallas", base=VESTA_SCALAR, scalar=PALLAS_SCALAR)
VESTA = Curve("vesta", base=PALLAS_SCALAR, scalar=VESTA_SCALAR)

# BN254 G1: y^2 = x^3 + 3 over Fq (= grumpkin scalar field), group order
# Fr (= the default Lurk bn256 field). Generator (1, 2).
BN254_G1 = Curve("bn254-g1", base=GRUMPKIN_SCALAR, scalar=BN256_SCALAR,
                 b=3, gen=(1, 2))

# Grumpkin: y^2 = x^3 - 17 over Fr, group order Fq (2-cycle with BN254).
# Generator (1, sqrt(-16)) per aztec's grumpkin spec.
_GRUMPKIN_B = (-17) % BN256_SCALAR.modulus


def _grumpkin_gen() -> Tuple[int, int]:
    c = Curve("grumpkin-tmp", base=BN256_SCALAR, scalar=GRUMPKIN_SCALAR,
              b=_GRUMPKIN_B, gen=(0, 0))
    for x in range(1, 64):
        pt = c.point_from_x(x, False)
        if pt is not None:
            return pt
    raise RuntimeError("no grumpkin generator found")


GRUMPKIN = Curve("grumpkin", base=BN256_SCALAR, scalar=GRUMPKIN_SCALAR,
                 b=_GRUMPKIN_B, gen=_grumpkin_gen())

# circuit field name -> commitment curve whose group order IS that field
CURVE_FOR_FIELD = {
    "pallas": PALLAS,
    "vesta": VESTA,
    "bn256": BN254_G1,
    "grumpkin": GRUMPKIN,
}
