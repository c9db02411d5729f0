"""SHA-256 as R1CS constraints over the gadget library.

A copy of the JAX package's ``r1cs/sha256_gadget.py`` (its additions
accumulate their linear combinations in place: the same constraints,
built without copying a combination for every term). Replaces the
bellpepper sha256 gadget used by the reference's sha256 coprocessor
(reference src/coprocessor/sha256.rs:1,53). Words are
32 booleans (LSB-first); per round:

  ch(e,f,g):  1 constraint/bit  (ch - g = e*(f - g))
  maj(a,b,c): 2 constraints/bit (t = b*c; m - t = a*(b + c - 2t))
  additions mod 2^32: one packing constraint over an LC sum with
  carry bits (32 + ceil(log2(k)) allocated bits per add).

Bit order convention matches bellpepper's sha256: the message is a
big-endian bit stream; words are internally LSB-first.
"""

from __future__ import annotations

from typing import List, Sequence

from .cs import LC, ConstraintSystem, lc_add, lc_scale, lc_sub
from .gadgets import Bool, alloc_bit, bool_xor

H_INIT = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)


class UInt32:
    """32 booleans, LSB-first. `value` is the u32 integer."""

    def __init__(self, bits: List[Bool], value: int):
        assert len(bits) == 32
        self.bits = bits
        self.value = value & 0xFFFFFFFF

    @staticmethod
    def constant(v: int) -> "UInt32":
        return UInt32(
            [Bool(None, const_val=bool((v >> i) & 1)) for i in range(32)],
            v)

    @staticmethod
    def from_bits_be(bits: Sequence[Bool]) -> "UInt32":
        bits = list(bits)
        assert len(bits) == 32
        lsb = bits[::-1]
        value = sum(int(b.value) << i for i, b in enumerate(lsb))
        return UInt32(lsb, value)

    def bits_be(self) -> List[Bool]:
        return self.bits[::-1]

    def rotr(self, n: int) -> "UInt32":
        bits = [self.bits[(i + n) % 32] for i in range(32)]
        v = ((self.value >> n) | (self.value << (32 - n))) & 0xFFFFFFFF
        return UInt32(bits, v)

    def shr(self, n: int) -> "UInt32":
        bits = [self.bits[i + n] if i + n < 32 else Bool.false()
                for i in range(32)]
        return UInt32(bits, self.value >> n)


def uint32_xor(cs: ConstraintSystem, *xs: UInt32) -> UInt32:
    bits = []
    for i in range(32):
        acc = xs[0].bits[i]
        for x in xs[1:]:
            acc = bool_xor(cs, acc, x.bits[i])
        bits.append(acc)
    v = 0
    for x in xs:
        v ^= x.value
    return UInt32(bits, v)


def uint32_ch(cs: ConstraintSystem, e: UInt32, f: UInt32,
              g: UInt32) -> UInt32:
    """ch = e ? f : g, bitwise: ch - g = e*(f - g)."""
    bits = []
    for i in range(32):
        eb, fb, gb = e.bits[i], f.bits[i], g.bits[i]
        val = fb.value if eb.value else gb.value
        r = alloc_bit(cs, val)
        cs.enforce(eb.lc(cs), lc_sub(fb.lc(cs), gb.lc(cs), cs.p),
                   lc_sub(r.lc(cs), gb.lc(cs), cs.p))
        bits.append(r)
    v = (e.value & f.value) | (~e.value & g.value) & 0xFFFFFFFF
    return UInt32(bits, v & 0xFFFFFFFF)


def uint32_maj(cs: ConstraintSystem, a: UInt32, b: UInt32,
               c: UInt32) -> UInt32:
    """maj bitwise: t = b*c; m - t = a*(b + c - 2t)."""
    bits = []
    for i in range(32):
        ab, bb, cb = a.bits[i], b.bits[i], c.bits[i]
        t_val = bb.value and cb.value
        m_val = (int(ab.value) + int(bb.value) + int(cb.value)) >= 2
        t = alloc_bit(cs, t_val)
        cs.enforce(bb.lc(cs), cb.lc(cs), t.lc(cs))
        m = alloc_bit(cs, m_val)
        rhs = lc_sub(lc_add(bb.lc(cs), cb.lc(cs), cs.p),
                     lc_scale(t.lc(cs), 2, cs.p), cs.p)
        cs.enforce(ab.lc(cs), rhs, lc_sub(m.lc(cs), t.lc(cs), cs.p))
        bits.append(m)
    v = (a.value & b.value) ^ (a.value & c.value) ^ (b.value & c.value)
    return UInt32(bits, v)


def _add_scaled(acc: LC, lc: LC, s: int, p: int) -> None:
    """``acc = lc_add(acc, lc_scale(lc, s, p), p)`` in place, for s a
    power of two below p: the same entries in the same order, without
    copying ``acc`` for every term."""
    for var, c in lc.items():
        nv = (acc.get(var, 0) + c * s) % p
        if nv:
            acc[var] = nv
        else:
            acc.pop(var, None)


def uint32_add(cs: ConstraintSystem, *xs: UInt32) -> UInt32:
    """Addition mod 2^32 of k words: one packing constraint + result/
    carry bit allocations."""
    k = len(xs)
    total = sum(x.value for x in xs)
    n_carry = max(1, (k - 1).bit_length())
    # LC of the full sum
    acc: LC = {}
    for x in xs:
        for i, b in enumerate(x.bits):
            _add_scaled(acc, b.lc(cs), 1 << i, cs.p)
    out_bits = [alloc_bit(cs, bool((total >> i) & 1)) for i in range(32)]
    carry_bits = [alloc_bit(cs, bool((total >> (32 + i)) & 1))
                  for i in range(n_carry)]
    packed: LC = {}
    for i, b in enumerate(out_bits):
        _add_scaled(packed, b.lc(cs), 1 << i, cs.p)
    for i, b in enumerate(carry_bits):
        _add_scaled(packed, b.lc(cs), 1 << (32 + i), cs.p)
    cs.enforce(lc_sub(acc, packed, cs.p),
               {ConstraintSystem.ONE_VAR: 1}, {})
    return UInt32(out_bits, total & 0xFFFFFFFF)


def sha256_compress(cs: ConstraintSystem, state: List[UInt32],
                    block: List[UInt32]) -> List[UInt32]:
    """One compression round over a 16-word block."""
    w = list(block)
    for i in range(16, 64):
        s0 = uint32_xor(cs, w[i - 15].rotr(7), w[i - 15].rotr(18),
                        w[i - 15].shr(3))
        s1 = uint32_xor(cs, w[i - 2].rotr(17), w[i - 2].rotr(19),
                        w[i - 2].shr(10))
        w.append(uint32_add(cs, w[i - 16], s0, w[i - 7], s1))
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = uint32_xor(cs, e.rotr(6), e.rotr(11), e.rotr(25))
        ch = uint32_ch(cs, e, f, g)
        temp1 = uint32_add(cs, h, s1, ch, UInt32.constant(K[i]), w[i])
        s0 = uint32_xor(cs, a.rotr(2), a.rotr(13), a.rotr(22))
        maj = uint32_maj(cs, a, b, c)
        temp2 = uint32_add(cs, s0, maj)
        h, g, f = g, f, e
        e = uint32_add(cs, d, temp1)
        d, c, b = c, b, a
        a = uint32_add(cs, temp1, temp2)
    return [
        uint32_add(cs, x, y)
        for x, y in zip(state, [a, b, c, d, e, f, g, h])
    ]


def sha256_bits(cs: ConstraintSystem, bits_be: List[Bool]) -> List[Bool]:
    """SHA-256 over a big-endian bit stream (multiple of 8 bits);
    returns 256 digest bits, big-endian (bellpepper sha256 parity)."""
    n_bits = len(bits_be)
    assert n_bits % 8 == 0
    # padding: 1 bit, zeros, 64-bit length
    padded = list(bits_be)
    padded.append(Bool.true())
    while (len(padded) + 64) % 512 != 0:
        padded.append(Bool.false())
    for i in range(63, -1, -1):
        padded.append(Bool(None, const_val=bool((n_bits >> i) & 1)))
    state = [UInt32.constant(v) for v in H_INIT]
    for off in range(0, len(padded), 512):
        block = [
            UInt32.from_bits_be(padded[off + 32 * j: off + 32 * (j + 1)])
            for j in range(16)
        ]
        state = sha256_compress(cs, state, block)
    out: List[Bool] = []
    for word in state:
        out.extend(word.bits_be())
    return out
