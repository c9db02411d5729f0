"""Short Weierstrass curves y^2 = x^3 + b on Python integers: BN254 G1
and Grumpkin, the port's curve cycle, from their public definitions.

Points are affine tuples ``(x, y)`` or None (the identity) at the
boundary; sums run in Jacobian coordinates. ``msm`` is a plain
Pippenger. ``generators`` derives a Pedersen key the way the port's key
is published (``lurk_tpu_torch/curves/weierstrass.py``: for index i,
the first attempt a = 0, 1, .. whose shake256(label || i || a) (33
bytes) gives an x, as 32 little-endian bytes mod p, on the curve; the
33rd byte's low bit is the parity of y), and keeps what it derived in
its own cache file, so a checkout pays the derivation once.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

Affine = Optional[Tuple[int, int]]
_INF = (0, 1, 0)
GEN = "generator"       # ``mul``'s default point (None is the identity)

CACHE_DIR = Path(__file__).resolve().parent.parent / ".cache" / "reference"


class Curve:
    def __init__(self, name: str, p: int, order: int, b: int,
                 gen: Tuple[int, int]):
        self.name, self.p, self.order, self.b = name, p, order, b % p
        self.generator = gen
        q, s = p - 1, 0
        while q % 2 == 0:
            q, s = q // 2, s + 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        self._ts = (q, s, pow(z, q, p))

    # -- Jacobian arithmetic (a = 0) -----------------------------------------

    def _dbl(self, pt):
        x1, y1, z1 = pt
        p = self.p
        if z1 == 0 or y1 == 0:
            return _INF
        a = x1 * x1 % p
        b = y1 * y1 % p
        c = b * b % p
        d = 2 * ((x1 + b) * (x1 + b) - a - c) % p
        e = 3 * a % p
        x3 = (e * e - 2 * d) % p
        return x3, (e * (d - x3) - 8 * c) % p, 2 * y1 * z1 % p

    def _add(self, p1, p2):
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        if z1 == 0:
            return p2
        if z2 == 0:
            return p1
        p = self.p
        z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
        u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
        s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
        if u1 == u2:
            return self._dbl(p1) if s1 == s2 else _INF
        h = (u2 - u1) % p
        i = 4 * h * h % p
        j = h * i % p
        r = 2 * (s2 - s1) % p
        v = u1 * i % p
        x3 = (r * r - j - 2 * v) % p
        return x3, (r * (v - x3) - 2 * s1 * j) % p, 2 * z1 * z2 * h % p

    def _madd(self, p1, x2, y2):
        x1, y1, z1 = p1
        if z1 == 0:
            return x2, y2, 1
        p = self.p
        z1z1 = z1 * z1 % p
        h = (x2 * z1z1 - x1) % p
        r = (y2 * z1 * z1z1 - y1) % p
        if h == 0:
            return self._dbl(p1) if r == 0 else _INF
        hh = h * h % p
        hhh = h * hh % p
        v = x1 * hh % p
        x3 = (r * r - hhh - 2 * v) % p
        return x3, (r * (v - x3) - y1 * hhh) % p, z1 * h % p

    def _jac(self, a: Affine):
        return _INF if a is None else (a[0], a[1], 1)

    def affine(self, pt) -> Affine:
        x, y, z = pt
        if z == 0:
            return None
        p = self.p
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        return x * zi2 % p, y * zi2 * zi % p

    # -- the public operations -------------------------------------------------

    def on_curve(self, a: Affine) -> bool:
        if a is None:
            return True
        x, y = a
        return (y * y - x * x * x - self.b) % self.p == 0

    def add(self, a: Affine, b: Affine) -> Affine:
        return self.affine(self._add(self._jac(a), self._jac(b)))

    def neg(self, a: Affine) -> Affine:
        return None if a is None else (a[0], (-a[1]) % self.p)

    def mul(self, k: int, a: Affine = GEN) -> Affine:
        a = self.generator if a is GEN else a
        k %= self.order
        if a is None or k == 0:
            return None
        acc, x, y = _INF, a[0], a[1]
        for bit in bin(k)[2:]:
            acc = self._dbl(acc)
            if bit == "1":
                acc = self._madd(acc, x, y)
        return self.affine(acc)

    def lincomb(self, terms: Sequence[Tuple[int, Affine]]) -> Affine:
        """sum_i k_i P_i, for a few terms."""
        acc = _INF
        for k, a in terms:
            m = self.mul(k, a)
            if m is not None:
                acc = self._madd(acc, m[0], m[1])
        return self.affine(acc)

    def msm(self, scalars: Sequence[int], points: Sequence[Affine]) -> Affine:
        """sum_i s_i P_i (Pippenger, unsigned windows)."""
        pairs = [(s % self.order, pt) for s, pt in zip(scalars, points)
                 if pt is not None and s % self.order]
        if not pairs:
            return None
        n = len(pairs)
        c = 4 if n < 32 else min(16, max(4, n.bit_length() - 3))
        mask = (1 << c) - 1
        acc = _INF
        for w in reversed(range((self.order.bit_length() + c - 1) // c)):
            for _ in range(c):
                acc = self._dbl(acc)
            buckets: List = [None] * (1 << c)
            shift = w * c
            for s, (x, y) in pairs:
                d = (s >> shift) & mask
                if d:
                    b = buckets[d]
                    buckets[d] = (x, y, 1) if b is None else \
                        self._madd(b, x, y)
            run = total = _INF
            for d in range(mask, 0, -1):
                b = buckets[d]
                if b is not None:
                    run = self._add(run, b)
                total = self._add(total, run)
            acc = self._add(acc, total)
        return self.affine(acc)

    # -- hash-derived generators -----------------------------------------------

    def sqrt(self, a: int) -> Optional[int]:
        p = self.p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        q, m, c = self._ts
        t, r = pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2, i = t2 * t2 % p, i + 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    def derive(self, label: bytes, start: int, end: int) -> List[Affine]:
        out: List[Affine] = []
        for i in range(start, end):
            for attempt in range(256):
                h = hashlib.shake_256(label + i.to_bytes(8, "little")
                                      + attempt.to_bytes(8, "little")
                                      ).digest(33)
                x = int.from_bytes(h[:32], "little") % self.p
                y = self.sqrt((x * x * x + self.b) % self.p)
                if y is None:
                    continue
                if y == 0 and h[32] & 1:
                    continue
                if y and (y & 1) != (h[32] & 1):
                    y = self.p - y
                out.append((x, y))
                break
            else:
                raise RuntimeError("generator derivation failed")
        return out

    def generators(self, label: bytes, n: int,
                   workers: int = 1) -> List[Affine]:
        """The first ``n`` generators of ``label``, from this reference's
        cache file where it holds them."""
        path = CACHE_DIR / f"gens_{self.name}_{label.hex()}.bin"
        have = b""
        if path.exists():
            have = path.read_bytes()
        have = have[:64 * (len(have) // 64)]
        if len(have) >= 64 * n:
            raw = have[:64 * n]
            return [(int.from_bytes(raw[k:k + 32], "little"),
                     int.from_bytes(raw[k + 32:k + 64], "little"))
                    for k in range(0, len(raw), 64)]
        start = len(have) // 64
        fresh = _parallel_derive(self, label, start, n, workers)
        raw = have + b"".join(x.to_bytes(32, "little") + y.to_bytes(32,
                                                                    "little")
                              for x, y in fresh)
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(raw)
        os.replace(tmp, path)
        return self.generators(label, n)


def _parallel_derive(curve: Curve, label: bytes, start: int, end: int,
                     workers: int) -> List[Affine]:
    if workers <= 1 or end - start < 1024:
        return curve.derive(label, start, end)
    from . import pool
    step = -(-(end - start) // workers)
    parts = [(curve.name, label, a, min(end, a + step))
             for a in range(start, end, step)]
    return [pt for chunk in pool.run(_derive_part, parts, workers)
            for pt in chunk]


def _derive_part(part) -> List[Affine]:
    name, label, start, end = part
    return CURVES[name].derive(label, start, end)


# BN254 G1 over Fq, of order r; Grumpkin over Fr, of order q (the cycle)
BN254_Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BN254 = Curve("bn254-g1", BN254_Q, BN254_R, 3, (1, 2))
GRUMPKIN = Curve("grumpkin", BN254_R, BN254_Q, -17,
                 (1, 0x2CF135E7506A45D632D270D45F1181294833FC48D823F272C))
CURVES = {c.name: c for c in (BN254, GRUMPKIN)}
