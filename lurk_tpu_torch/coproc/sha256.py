"""Sha256 coprocessor: its evaluation and its circuit.

The port of the JAX package's ``coproc/sha256.py`` (reference
src/coprocessor/sha256.rs:21-120). For each argument's z-pointer, 64
bytes are laid out (32 little-endian tag bytes, 32 little-endian digest
bytes); the whole buffer is reversed, hashed with sha256, and the
big-endian digest integer is truncated to the field's capacity
(``num_bits - 1``), matching the reference's pack_bits/discard_bits bit
for bit.

The circuit (:class:`Sha256Circuit`) synthesizes the whole sha256 in
R1CS (:mod:`..r1cs.sha256_gadget`), as the reference's CoCircuit does.
"""

from __future__ import annotations

import hashlib
from typing import List

from ..lem.circuit import AllocatedPtr
from ..lem.evaluation import Coprocessor
from ..r1cs.cs import ConstraintSystem, lc_add, lc_scale, lc_sub
from ..r1cs.gadgets import Bool, Num, alloc_num, to_bits_le_strict
from ..r1cs.sha256_gadget import sha256_bits
from ..store.core import Ptr, Store
from ..symbol import Symbol, user_sym
from ..tags import ExprTag


def compute_sha256(store: Store, z_ptrs) -> int:
    field = store.field
    buf = bytearray()
    for z in z_ptrs:
        buf += int(z.tag).to_bytes(32, "little")
        buf += z.digest.to_bytes(32, "little")
    buf.reverse()
    digest = hashlib.sha256(bytes(buf)).digest()
    v = int.from_bytes(digest, "big")
    capacity = field.num_bits - 1
    return v & ((1 << capacity) - 1)


def sha256_evaluate(store: Store, args: List[Ptr]) -> Ptr:
    z_ptrs = [store.hash_ptr(p) for p in args]
    return store.num(compute_sha256(store, z_ptrs))


def sha256_coprocessor(n: int) -> Coprocessor:
    """The sha256 coprocessor of arity n: its evaluation and its
    circuit."""
    return Coprocessor(arity=n, evaluate=sha256_evaluate,
                       circuit=Sha256Circuit(n))


def _pad8(bits: List[Bool]) -> None:
    while len(bits) % 8:
        bits.append(Bool.false())


class Sha256Circuit:
    """The circuit side (CoCircuit parity, sha256.rs:27-66): a strict bit
    decomposition of each argument's tag and digest, byte-padded and
    reversed, sha256 in the circuit, the digest packed to the field's
    capacity."""

    def __init__(self, n: int):
        self.n = n

    def synthesize(self, synth, not_dummy, inp):
        cs = synth.cs
        # inp = [args..., env, cont]; env and cont pass through unchanged
        # (CoCircuit::synthesize_internal parity, coprocessor/mod.rs:57-112)
        args, env, cont = inp[:self.n], inp[-2], inp[-1]
        bits: List[Bool] = []
        for ptr in args:
            bits.extend(to_bits_le_strict(cs, ptr.tag))
            _pad8(bits)
            bits.extend(to_bits_le_strict(cs, ptr.hash))
            _pad8(bits)
        bits.reverse()
        digest_bits = sha256_bits(cs, bits)
        digest_bits.reverse()   # now LSB-first
        capacity = cs.field.num_bits - 1
        take = digest_bits[:capacity]
        value = sum(int(b.value) << i for i, b in enumerate(take))
        out = alloc_num(cs, value)
        pack = {}
        for i, b in enumerate(take):
            pack = lc_add(pack, lc_scale(b.lc(cs), 1 << i, cs.p), cs.p)
        cs.enforce(lc_sub(pack, out.lc, cs.p),
                   {ConstraintSystem.ONE_VAR: 1}, {})
        result = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)), out)
        return [result, env, cont]


def sha256_nivc_symbol(n: int) -> Symbol:
    """The symbol of the reference's sha256_nivc example."""
    return user_sym(f"sha256_nivc_{n}")
