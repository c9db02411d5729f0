"""ZData: the compact self-describing binary tree format.

A copy of the JAX package's ``store/z_data.py``. Byte-format parity:
reference src/z_data.rs:33-210. A value is an Atom (byte leaf) or a Cell
(children); the tag byte encodes the kind and a small length (< 64
inline, 64 as the small size 0, else a trimmed little-endian size
prefix follows).

Also the field-element codec of the legacy ZExpr/ZCont serialization
(z_expr.rs/z_cont.rs): field elements as 32-byte little-endian atoms.
"""

from __future__ import annotations

from typing import List, Tuple, Union

ZData = Union["Atom", "Cell"]


class Atom:
    __slots__ = ("bytes",)

    def __init__(self, data: bytes):
        self.bytes = bytes(data)

    def __eq__(self, other):
        return isinstance(other, Atom) and self.bytes == other.bytes

    def __repr__(self):
        return f"[a:{', '.join(f'{b:02x}' for b in self.bytes)}]"


class Cell:
    __slots__ = ("children",)

    def __init__(self, children: List[ZData]):
        self.children = list(children)

    def __eq__(self, other):
        return isinstance(other, Cell) and self.children == other.children

    def __repr__(self):
        return f"[c:{', '.join(map(repr, self.children))}]"


def byte_count(x: int) -> int:
    """Bytes needed for x in trimmed little-endian (z_data.rs:82-89)."""
    if x == 0:
        return 1
    return (x.bit_length() - 1) // 8 + 1


def to_trimmed_le_bytes(x: int) -> bytes:
    return x.to_bytes(byte_count(x), "little")


def _tag(z: ZData) -> int:
    if isinstance(z, Atom):
        kind, n = 0b0000_0000, len(z.bytes)
    else:
        kind, n = 0b1000_0000, len(z.children)
    if n == 0:
        return kind
    if n < 64:
        return kind | 0b0100_0000 | n
    if n == 64:
        return kind | 0b0100_0000
    return kind | byte_count(n)


def to_bytes(z: ZData) -> bytes:
    out = bytearray([_tag(z)])
    if isinstance(z, Atom):
        if len(z.bytes) > 64:
            out += to_trimmed_le_bytes(len(z.bytes))
        out += z.bytes
    else:
        if len(z.children) > 64:
            out += to_trimmed_le_bytes(len(z.children))
        for c in z.children:
            out += to_bytes(c)
    return bytes(out)


def _from_bytes_aux(data: bytes, off: int) -> Tuple[ZData, int]:
    tag = data[off]
    off += 1
    size = tag & 0b11_1111
    if tag & 0b0100_0000:            # small: the size is in the tag
        size = size or 64
    else:                            # a prefix of `size` bytes holds it
        if size > 8:
            raise ValueError("size prefix too long")
        raw = data[off:off + size]
        if len(raw) < size:
            raise ValueError("truncated size prefix")
        off += size
        size = int.from_bytes(raw, "little")
    if not tag & 0b1000_0000:        # atom
        raw = data[off:off + size]
        if len(raw) < size:
            raise ValueError("truncated atom")
        return Atom(raw), off + size
    children = []
    for _ in range(size):
        child, off = _from_bytes_aux(data, off)
        children.append(child)
    return Cell(children), off


def from_bytes(data: bytes) -> ZData:
    return _from_bytes_aux(data, 0)[0]


# -- field codec (z_expr/z_cont atoms) ---------------------------------------


def f_to_atom(f: int) -> Atom:
    return Atom(f.to_bytes(32, "little"))


def atom_to_f(a: Atom) -> int:
    return int.from_bytes(a.bytes, "little")
