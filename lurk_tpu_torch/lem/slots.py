"""Slot optimizer: static analysis of per-Func slot requirements.

A "slot" is a shared expensive gadget instance (Poseidon hash, commitment,
bit decomposition) reused across mutually-exclusive execution paths via
implication gadgets. The count is the max over any execution path.

Parity: reference src/lem/slot.rs:106-240 (SlotsCounter,
Block::count_slots). For the default Lurk step function the counts are
hash4=14, hash6=0, hash8=6, commitment=1, bit_decomp=3
(src/lem/eval.rs:1961-1965) — pinned by tests.
"""

from __future__ import annotations

import dataclasses

from . import ir

# Slot types
HASH4 = "hash4"
HASH6 = "hash6"
HASH8 = "hash8"
COMMITMENT = "commitment"
BIT_DECOMP = "bit_decomp"

SLOT_TYPES = (HASH4, HASH6, HASH8, COMMITMENT, BIT_DECOMP)

# preimage size (field elements) per slot type
PREIMG_SIZE = {HASH4: 4, HASH6: 6, HASH8: 8, COMMITMENT: 3, BIT_DECOMP: 1}


@dataclasses.dataclass(frozen=True)
class SlotsCounter:
    hash4: int = 0
    hash6: int = 0
    hash8: int = 0
    commitment: int = 0
    bit_decomp: int = 0

    def add(self, o: "SlotsCounter") -> "SlotsCounter":
        return SlotsCounter(
            self.hash4 + o.hash4, self.hash6 + o.hash6, self.hash8 + o.hash8,
            self.commitment + o.commitment, self.bit_decomp + o.bit_decomp)

    def cmp_max(self, o: "SlotsCounter") -> "SlotsCounter":
        return SlotsCounter(
            max(self.hash4, o.hash4), max(self.hash6, o.hash6),
            max(self.hash8, o.hash8), max(self.commitment, o.commitment),
            max(self.bit_decomp, o.bit_decomp))

    def get(self, slot_type: str) -> int:
        return getattr(self, slot_type)

    def total(self) -> int:
        return (self.hash4 + self.hash6 + self.hash8 + self.commitment
                + self.bit_decomp)


_OP_SLOTS = {
    ir.CONS2: SlotsCounter(hash4=1),
    ir.DECONS2: SlotsCounter(hash4=1),
    ir.PUSHBINDING: SlotsCounter(hash4=1),
    ir.POPBINDING: SlotsCounter(hash4=1),
    ir.CONS3: SlotsCounter(hash6=1),
    ir.DECONS3: SlotsCounter(hash6=1),
    ir.CONS4: SlotsCounter(hash8=1),
    ir.DECONS4: SlotsCounter(hash8=1),
    ir.HIDE: SlotsCounter(commitment=1),
    ir.OPEN: SlotsCounter(commitment=1),
    ir.LT: SlotsCounter(bit_decomp=3),
    ir.TRUNC: SlotsCounter(bit_decomp=1),
}

_ZERO = SlotsCounter()


def count_slots(b: ir.Block) -> SlotsCounter:
    acc = _ZERO
    for op in b.ops:
        if op[0] == ir.CALL:
            acc = acc.add(op[2].slots_count)
        else:
            acc = acc.add(_OP_SLOTS.get(op[0], _ZERO))
    c = b.ctrl
    if isinstance(c, ir.Return):
        ctrl_slots = _ZERO
    elif isinstance(c, ir.If):
        ctrl_slots = count_slots(c.true_block).cmp_max(
            count_slots(c.false_block))
    else:
        ctrl_slots = (count_slots(c.default) if c.default is not None
                      else _ZERO)
        for _, blk in c.cases:
            ctrl_slots = ctrl_slots.cmp_max(count_slots(blk))
    return acc.add(ctrl_slots)
