"""Legacy ZExpr/ZCont/ZStore content-addressing model + ZData serde.

A copy of the JAX package's ``store/z_legacy.py``, hashing through the
store's :class:`.core.PoseidonMemo` (the host Poseidon). Functionality
parity: reference src/z_data/{z_expr.rs:23-161, z_cont.rs:22-342,
z_store.rs:23-138, serde/ser.rs, serde/de.rs}: the pre-LEM
serialization model where every Lurk expression variant and every
continuation variant has an explicit content-addressed form:
continuations hash as 8-ary Poseidon over per-variant
`hash_components` padded with zeros, strings/symbols as hash4 cons
chains, functions as hash6 triples.

Cross-model anchor: the legacy string/symbol/nil hashing coincides with
the current store's interning rules, so `put_symbol(.lurk.nil)`
reproduces the store's nil digest.

ZData serde encoding (serde/ser.rs rules): unit variant ->
Cell[Atom[idx]]; newtype/tuple/struct variant -> Cell[Atom[idx],
fields...]; plain struct -> Cell[fields...]; map -> flat alternating
Cell[k0, v0, k1, v1, ...]; Option: None -> Atom[], Some x -> Cell[x];
u8/u16/u32/u64 -> fixed-width LE atoms; char -> u32; field elements ->
32-byte LE atoms (halo2curves derive_serde `to_repr` bytes). The
readers raise ``ValueError`` on data of the wrong shape, where the JAX
ones assert.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..fields import FieldSpec, from_char, to_char
from ..symbol import Symbol
from ..tags import ContTag, ExprTag, Op1, Op2
from .core import PoseidonMemo, ZPtr
from .z_data import Atom, Cell, ZData

# serde variant indices (declaration order in the reference enums)
_ZEXPR_VARIANTS = [
    "Nil", "Cons", "Comm", "RootSym", "RootKey", "Sym", "Key", "Fun",
    "Num", "EmptyStr", "Str", "Thunk", "Char", "UInt",
]
_ZCONT_VARIANTS = [
    "Outermost", "Call0", "Call", "Call2", "Tail", "Error", "Lookup",
    "Unop", "Binop", "Binop2", "If", "Let", "LetRec", "Emit", "Dummy",
    "Terminal",
]


@dataclasses.dataclass(frozen=True)
class ZExpr:
    """Tagged legacy expression: variant name + ZPtr/int fields in the
    reference's declaration order (z_expr.rs:23-49)."""

    variant: str
    fields: Tuple = ()

    def z_ptr(self, cache: PoseidonMemo, field: FieldSpec) -> ZPtr:
        v, f = self.variant, self.fields
        h4 = (lambda a, b: cache.hash((a.tag, a.digest, b.tag, b.digest)))
        if v == "Nil":
            return ZPtr(ExprTag.Nil,
                        ZStoreLegacy().nil_z_ptr(cache, field).digest)
        if v == "Cons":
            return ZPtr(ExprTag.Cons, h4(*f))
        if v == "Comm":
            secret, x = f
            return ZPtr(ExprTag.Comm,
                        cache.hash((secret, x.tag, x.digest)))
        if v == "RootSym":
            return ZPtr(ExprTag.Sym, 0)
        if v == "RootKey":
            return ZPtr(ExprTag.Key, 0)
        if v == "Sym":
            return ZPtr(ExprTag.Sym, h4(*f))
        if v == "Key":
            return ZPtr(ExprTag.Key, h4(*f))
        if v == "Fun":
            arg, body, env = f
            return ZPtr(ExprTag.Fun, cache.hash(
                (arg.tag, arg.digest, body.tag, body.digest, env.tag,
                 env.digest)))
        if v == "Num":
            return ZPtr(ExprTag.Num, f[0] % field.modulus)
        if v == "EmptyStr":
            return ZPtr(ExprTag.Str, 0)
        if v == "Str":
            return ZPtr(ExprTag.Str, h4(*f))
        if v == "Thunk":
            return ZPtr(ExprTag.Thunk, h4(*f))
        if v == "Char":
            return ZPtr(ExprTag.Char, from_char(f[0]))
        if v == "UInt":
            return ZPtr(ExprTag.U64, f[0] & 0xFFFFFFFFFFFFFFFF)
        raise ValueError(f"unknown ZExpr variant {v}")


@dataclasses.dataclass(frozen=True)
class ZCont:
    """Legacy continuation: variant + fields in declaration order
    (z_cont.rs:22-108); 8-ary zero-padded hashing (z_cont.rs:91-233)."""

    variant: str
    fields: Tuple = ()

    def hash_components(self) -> List[int]:
        v, f = self.variant, self.fields
        pair = lambda z: [z.tag, z.digest]          # noqa: E731
        out: List[int] = []
        if v in ("Outermost", "Error", "Dummy", "Terminal"):
            out = []
        elif v == "Call":
            out = pair(f[0]) + pair(f[1]) + pair(f[2])
        elif v == "Call2":
            out = pair(f[0]) + pair(f[1]) + pair(f[2])
        elif v in ("Call0", "Tail", "Lookup"):
            out = pair(f[0]) + pair(f[1])
        elif v == "Unop":
            out = [int(f[0]), 0] + pair(f[1])
        elif v == "Binop":
            out = [int(f[0]), 0] + pair(f[1]) + pair(f[2]) + pair(f[3])
        elif v == "Binop2":
            out = [int(f[0]), 0] + pair(f[1]) + pair(f[2])
        elif v == "If":
            out = pair(f[0]) + pair(f[1])
        elif v in ("Let", "LetRec"):
            out = pair(f[0]) + pair(f[1]) + pair(f[2]) + pair(f[3])
        elif v == "Emit":
            out = pair(f[0])
        else:
            raise ValueError(f"unknown ZCont variant {v}")
        return out + [0] * (8 - len(out))

    def z_ptr(self, cache: PoseidonMemo) -> ZPtr:
        digest = cache.hash(tuple(self.hash_components()))
        return ZPtr(getattr(ContTag, self.variant), digest)


class ZStoreLegacy:
    """expr_map/cont_map content-addressed store (z_store.rs:35-38)."""

    def __init__(self) -> None:
        self.expr_map: Dict[ZPtr, Optional[ZExpr]] = {}
        self.cont_map: Dict[ZPtr, Optional[ZCont]] = {}

    # -- immediate values (z_store.rs:57-76) -------------------------------

    @staticmethod
    def immediate_z_expr(ptr: ZPtr) -> Optional[ZExpr]:
        if ptr.tag == ExprTag.U64:
            return ZExpr("UInt", (ptr.digest,))
        if ptr.tag == ExprTag.Char:
            c = to_char(ptr.digest)
            return None if c is None else ZExpr("Char", (c,))
        if ptr.tag == ExprTag.Num:
            return ZExpr("Num", (ptr.digest,))
        if ptr.tag == ExprTag.Str and ptr.digest == 0:
            return ZExpr("EmptyStr")
        if ptr.tag == ExprTag.Sym and ptr.digest == 0:
            return ZExpr("RootSym")
        if ptr.tag == ExprTag.Key and ptr.digest == 0:
            # faithful to z_store.rs:71 (returns RootSym, not RootKey)
            return ZExpr("RootSym")
        return None

    def insert_z_expr(self, ptr: ZPtr, expr: Optional[ZExpr]) -> None:
        if ZStoreLegacy.immediate_z_expr(ptr) is None:
            self.expr_map[ptr] = expr

    def insert_z_cont(self, ptr: ZPtr, cont: Optional[ZCont]) -> None:
        self.cont_map[ptr] = cont

    def get_expr(self, ptr: ZPtr) -> Optional[ZExpr]:
        imm = ZStoreLegacy.immediate_z_expr(ptr)
        return imm if imm is not None else self.expr_map.get(ptr)

    def get_cont(self, ptr: ZPtr) -> Optional[ZCont]:
        return self.cont_map.get(ptr)

    # -- builders (z_store.rs:99-138) --------------------------------------

    def nil_z_ptr(self, cache: PoseidonMemo, field: FieldSpec) -> ZPtr:
        z = self.put_symbol(Symbol(("lurk", "nil")), cache, field)[0]
        return ZPtr(ExprTag.Nil, z.digest)

    def put_string(self, s: str, cache: PoseidonMemo,
                   field: FieldSpec) -> Tuple[ZPtr, ZExpr]:
        expr = ZExpr("EmptyStr")
        ptr = expr.z_ptr(cache, field)
        for c in reversed(s):
            char_ptr = ZPtr(ExprTag.Char, from_char(c))
            expr = ZExpr("Str", (char_ptr, ptr))
            ptr = expr.z_ptr(cache, field)
        self.insert_z_expr(ptr, expr)
        return ptr, expr

    def put_symbol(self, sym: Symbol, cache: PoseidonMemo,
                   field: FieldSpec) -> Tuple[ZPtr, ZExpr]:
        expr = ZExpr("RootSym")
        ptr = expr.z_ptr(cache, field)
        for s in sym.path:
            str_ptr, _ = self.put_string(s, cache, field)
            expr = ZExpr("Sym", (str_ptr, ptr))
            ptr = expr.z_ptr(cache, field)
        self.insert_z_expr(ptr, expr)
        return ptr, expr


# ---------------------------------------------------------------------------
# ZData serde adapters (serde/ser.rs + de.rs rules)
# ---------------------------------------------------------------------------


def _u8(v: int) -> Atom:
    return Atom(bytes([v & 0xFF]))


def _u64(v: int) -> Atom:
    return Atom(int(v).to_bytes(8, "little"))


def _u32(v: int) -> Atom:
    return Atom(int(v).to_bytes(4, "little"))


def _f(v: int) -> Atom:
    return Atom(int(v).to_bytes(32, "little"))


def _tag_ser(tag: int) -> ZData:
    """Unit-variant enums (ExprTag/ContTag/Op1/Op2): index = low bits."""
    return Cell([_u8(tag & 0xFFF)])


def _zptr_ser(z: ZPtr) -> ZData:
    return Cell([_tag_ser(z.tag), _f(z.digest)])


def _cell(d: ZData, n: Optional[int] = None) -> Cell:
    """``d`` as a Cell (of ``n`` children when given), else ValueError."""
    if not isinstance(d, Cell) or (n is not None and len(d.children) != n):
        raise ValueError(f"expected a cell{'' if n is None else f' of {n}'}"
                         f", got {d!r}")
    return d


def _zptr_de(d: ZData, base: int) -> ZPtr:
    _cell(d, 2)
    tag_cell, f_atom = d.children
    idx = tag_cell.children[0].bytes[0]
    return ZPtr(base | idx, int.from_bytes(f_atom.bytes, "little"))


def zexpr_to_z_data(e: ZExpr) -> ZData:
    idx = _ZEXPR_VARIANTS.index(e.variant)
    cell: List[ZData] = [_u8(idx)]
    if e.variant in ("Cons", "Sym", "Key", "Str", "Fun"):
        cell += [_zptr_ser(z) for z in e.fields]
    elif e.variant == "Thunk":
        cell += [_zptr_ser(e.fields[0]), _zptr_ser(e.fields[1])]
    elif e.variant == "Comm":
        cell += [_f(e.fields[0]), _zptr_ser(e.fields[1])]
    elif e.variant == "Num":
        cell += [_f(e.fields[0])]
    elif e.variant == "Char":
        cell += [_u32(ord(e.fields[0]))]
    elif e.variant == "UInt":
        cell += [Cell([_u8(0), _u64(e.fields[0])])]
    return Cell(cell)


def zexpr_from_z_data(d: ZData) -> ZExpr:
    _cell(d)
    idx = d.children[0].bytes[0]
    v = _ZEXPR_VARIANTS[idx]
    args = d.children[1:]
    if v in ("Nil", "RootSym", "RootKey", "EmptyStr"):
        return ZExpr(v)
    if v in ("Cons", "Sym", "Key", "Str"):
        return ZExpr(v, (_zptr_de(args[0], 0), _zptr_de(args[1], 0)))
    if v == "Fun":
        return ZExpr(v, tuple(_zptr_de(a, 0) for a in args))
    if v == "Thunk":
        return ZExpr(v, (_zptr_de(args[0], 0),
                         _zptr_de(args[1], ContTag.Outermost & 0xF000)))
    if v == "Comm":
        return ZExpr(v, (int.from_bytes(args[0].bytes, "little"),
                         _zptr_de(args[1], 0)))
    if v == "Num":
        return ZExpr(v, (int.from_bytes(args[0].bytes, "little"),))
    if v == "Char":
        return ZExpr(v, (chr(int.from_bytes(args[0].bytes, "little")),))
    if v == "UInt":
        inner = args[0]
        return ZExpr(v, (int.from_bytes(inner.children[1].bytes,
                                        "little"),))
    raise ValueError(f"bad ZExpr data {d}")


_ZCONT_OPS = {"Unop": Op1, "Binop": Op2, "Binop2": Op2}


def zcont_to_z_data(c: ZCont) -> ZData:
    idx = _ZCONT_VARIANTS.index(c.variant)
    cell: List[ZData] = [_u8(idx)]
    fields = list(c.fields)
    if c.variant in _ZCONT_OPS:
        cell.append(_tag_ser(int(fields.pop(0))))
    for z in fields:
        cell.append(_zptr_ser(z))
    return Cell(cell)


def zcont_from_z_data(d: ZData) -> ZCont:
    _cell(d)
    idx = d.children[0].bytes[0]
    v = _ZCONT_VARIANTS[idx]
    args = list(d.children[1:])
    fields: List = []
    if v in _ZCONT_OPS:
        op_enum = _ZCONT_OPS[v]
        base = Op1.Car & 0xF000 if op_enum is Op1 else Op2.Sum & 0xF000
        fields.append(op_enum(base | args.pop(0).children[0].bytes[0]))
    n_ptrs = len(args)
    for i, a in enumerate(args):
        cont_base = ContTag.Outermost & 0xF000
        is_cont = i == n_ptrs - 1      # continuation is always last
        fields.append(_zptr_de(a, cont_base if is_cont else 0))
    return ZCont(v, tuple(fields))


def zstore_to_z_data(zs: ZStoreLegacy) -> ZData:
    def opt(v, enc) -> ZData:
        return Atom(b"") if v is None else Cell([enc(v)])

    expr_cell: List[ZData] = []
    for ptr in sorted(zs.expr_map, key=lambda z: (z.tag, z.digest)):
        expr_cell += [_zptr_ser(ptr),
                      opt(zs.expr_map[ptr], zexpr_to_z_data)]
    cont_cell: List[ZData] = []
    for ptr in sorted(zs.cont_map, key=lambda z: (z.tag, z.digest)):
        cont_cell += [_zptr_ser(ptr),
                      opt(zs.cont_map[ptr], zcont_to_z_data)]
    return Cell([Cell(expr_cell), Cell(cont_cell)])


def zstore_from_z_data(d: ZData) -> ZStoreLegacy:
    _cell(d, 2)
    zs = ZStoreLegacy()
    expr_cell, cont_cell = d.children
    ch = expr_cell.children
    for i in range(0, len(ch), 2):
        ptr = _zptr_de(ch[i], 0)
        val = ch[i + 1]
        zs.expr_map[ptr] = (None if isinstance(val, Atom)
                            else zexpr_from_z_data(val.children[0]))
    ch = cont_cell.children
    for i in range(0, len(ch), 2):
        ptr = _zptr_de(ch[i], ContTag.Outermost & 0xF000)
        val = ch[i + 1]
        zs.cont_map[ptr] = (None if isinstance(val, Atom)
                            else zcont_from_z_data(val.children[0]))
    return zs
