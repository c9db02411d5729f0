"""In-circuit Fiat-Shamir transcript for the Nova augmented circuit.

A copy of the JAX package's ``r1cs/ro_gadget.py`` over the port's
:mod:`..poseidon.circuit`.

Mirrors proof/transcript.py BIT-EXACTLY (same chained arity-4 Poseidon
compression, same squeeze domain separation, same 124-bit truncation) so
the challenge the augmented circuit derives equals the one the host
prover/verifier derives. Plays the role of arecibo's in-circuit
`PoseidonROCircuit` (external crate; driven by the augmented circuit of
reference src/proof/nova.rs via the arecibo dep)."""

from __future__ import annotations

from typing import List, Tuple

from ..poseidon.circuit import poseidon_circuit
from ..proof.transcript import CHALLENGE_BITS
from .cs import ConstraintSystem, lc_add, lc_scale
from .gadgets import (
    Bool, Num, alloc_num, enforce_equal, to_bits_le_strict,
)


class TranscriptGadget:
    """Absorb allocated Nums, squeeze an allocated challenge."""

    def __init__(self, cs: ConstraintSystem, domain: bytes):
        self.cs = cs
        init = int.from_bytes(domain.ljust(16, b"\0")[:16], "little")
        self.state: Num = Num.constant(cs, init)
        self._buf: List[Num] = []

    def absorb(self, num: Num) -> None:
        self._buf.append(num)

    def absorb_const(self, v: int) -> None:
        self._buf.append(Num.constant(self.cs, v))

    def absorb_limbs(self, lo: Num, hi: Num) -> None:
        """Counterpart of host absorb_scalar's 128-bit limb split (used
        when the absorbed scalar's field exceeds the circuit field)."""
        self._buf.append(lo)
        self._buf.append(hi)

    def absorb_bignat(self, bn, modulus: int) -> None:
        """Host absorb_scalar parity: limb-split only when the scalar's
        modulus exceeds the circuit field, else absorb whole."""
        if modulus > self.cs.p:
            lo, hi = bn.lo_hi()
            self.absorb_limbs(lo, hi)
        else:
            self.absorb(bn.packed(self.cs))

    def absorb_point(self, x: Num, y: Num, is_id: Bool) -> None:
        """Host absorbs (0, 0, 1) for the identity and (x, y, 0)
        otherwise; ec_normalize yields exactly (0, 0, flag)."""
        cs = self.cs
        self._buf.append(x)
        self._buf.append(y)
        self._buf.append(Num(is_id.lc(cs), 1 if is_id.value else 0))

    def _compress(self) -> None:
        cs = self.cs
        data = [self.state] + self._buf
        self._buf = []
        zero = Num.constant(cs, 0)
        while len(data) > 1:
            chunk = data[:4]
            chunk += [zero] * (4 - len(chunk))
            if cs.witness_only:
                from ..poseidon.circuit import poseidon_witness
                digest = poseidon_witness(cs, cs.field, chunk)
            else:
                digest = poseidon_circuit(cs, cs.field, chunk)
            # re-allocate: keeps downstream LCs sparse
            d = alloc_num(cs, digest.value)
            enforce_equal(cs, d, digest)
            data = [d] + data[4:]
        self.state = data[0]

    def squeeze(self) -> Tuple[Num, List[Bool]]:
        """(challenge, its CHALLENGE_BITS little-endian bits). The full
        digest stays as the running state (host parity)."""
        cs = self.cs
        self.absorb_const(1)   # squeeze domain separation
        self._compress()
        bits = to_bits_le_strict(cs, self.state)
        lc = {}
        val = 0
        for i in range(CHALLENGE_BITS):
            lc = lc_add(lc, lc_scale(bits[i].lc(cs), 1 << i, cs.p), cs.p)
            if bits[i].value:
                val += 1 << i
        return Num(lc, val), bits[:CHALLENGE_BITS]
