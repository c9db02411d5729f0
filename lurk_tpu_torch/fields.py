"""Host-side prime-field parameters and arithmetic for lurk_tpu_torch.

Fields mirror the four Lurk language fields (reference: src/field.rs:40-50,
264-278) plus the matching curve base fields needed for commitments:

  - ``bn256``   : BN254 scalar field Fr (the default Lurk field)
  - ``grumpkin``: Grumpkin scalar field = BN254 base field Fq
  - ``pallas``  : Pallas scalar field Fq (pasta_curves pallas::Scalar)
  - ``vesta``   : Vesta scalar field Fp (pasta_curves vesta::Scalar)

Host arithmetic is plain Python integers mod p; it is the bit-exactness
reference for the limb arithmetic in :mod:`lurk_tpu_torch.ops.field` and
the CUDA core in ``csrc/field.cuh``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = [
    "FieldSpec",
    "FIELDS",
    "field",
    "BN256_SCALAR",
    "GRUMPKIN_SCALAR",
    "PALLAS_SCALAR",
    "VESTA_SCALAR",
    "PALLAS_BASE",
    "VESTA_BASE",
]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field.

    ``num_bits`` mirrors ff::PrimeField::NUM_BITS; ``name`` matches the
    reference's LanguageField display strings (src/field.rs:52-62).
    """

    name: str
    modulus: int

    @property
    def num_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def num_bytes(self) -> int:
        # All supported fields have 32-byte little-endian reprs.
        return 32

    # --- element helpers (elements are plain ints in [0, modulus)) ---

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError("field inversion of zero")
        return pow(a, self.modulus - 2, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def from_le_bytes(self, bs: bytes) -> int:
        v = int.from_bytes(bs, "little")
        if v >= self.modulus:
            raise ValueError("non-canonical field repr")
        return v

    def to_le_bytes(self, a: int) -> bytes:
        return (a % self.modulus).to_bytes(self.num_bytes, "little")

    def hex_digits(self, a: int) -> str:
        """Big-endian hex digits as printed by the reference
        (LurkField::hex_digits, src/field.rs)."""
        return (a % self.modulus).to_bytes(self.num_bytes, "big").hex()

    # Field ordering helpers (reference: src/field.rs most_positive/negative)
    @property
    def most_negative(self) -> int:
        """most_positive + 1: the smallest field element interpreted as
        negative under Lurk's signed ordering."""
        return self.most_positive + 1

    @property
    def most_positive(self) -> int:
        """(modulus - 1) / 2"""
        return (self.modulus - 1) // 2


# BN254 (a.k.a. BN256 in halo2curves) scalar field Fr.
BN256_SCALAR = FieldSpec(
    "bn256",
    0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
)

# BN254 base field Fq == Grumpkin scalar field.
GRUMPKIN_SCALAR = FieldSpec(
    "grumpkin",
    0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
)

# pasta_curves pallas::Scalar (Fq) — order of the Pallas group.
PALLAS_SCALAR = FieldSpec(
    "pallas",
    0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
)

# pasta_curves vesta::Scalar (Fp) — order of the Vesta group,
# also the Pallas base field.
VESTA_SCALAR = FieldSpec(
    "vesta",
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
)

# Curve base-field aliases for EC/MSM code.
PALLAS_BASE = dataclasses.replace(VESTA_SCALAR, name="pallas-base")
VESTA_BASE = dataclasses.replace(PALLAS_SCALAR, name="vesta-base")

FIELDS: Dict[str, FieldSpec] = {
    "bn256": BN256_SCALAR,
    "grumpkin": GRUMPKIN_SCALAR,
    "pallas": PALLAS_SCALAR,
    "vesta": VESTA_SCALAR,
}


def field(name: str) -> FieldSpec:
    return FIELDS[name]


# -- element codecs (LurkField parity: src/field.rs:64-263) -------------------


def to_char(f: int) -> "str | None":
    """Field element -> char if it fits 32 bits and is a valid scalar."""
    if 0 <= f < 0x110000:
        try:
            return chr(f)
        except ValueError:
            return None
    return None


def from_char(c: str) -> int:
    return ord(c)


def to_u64(field_spec: FieldSpec, f: int) -> "int | None":
    """Canonical u64 if the element fits (LurkField::to_u64)."""
    f %= field_spec.modulus
    return f if f < (1 << 64) else None


def to_u64_unchecked(f: int) -> int:
    """Low 64 bits of the LE repr (LurkField::to_u64_unchecked)."""
    return f & ((1 << 64) - 1)


def to_u16(field_spec: FieldSpec, f: int) -> "int | None":
    f %= field_spec.modulus
    return f if f < (1 << 16) else None


def to_u32(field_spec: FieldSpec, f: int) -> "int | None":
    f %= field_spec.modulus
    return f if f < (1 << 32) else None


def to_u128(field_spec: FieldSpec, f: int) -> "int | None":
    f %= field_spec.modulus
    return f if f < (1 << 128) else None
