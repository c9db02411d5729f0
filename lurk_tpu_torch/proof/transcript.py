"""Poseidon-based Fiat-Shamir random oracle for the folding scheme.

A copy of the JAX package's ``proof/transcript.py``, hashing through
the host C++ Poseidon (:func:`..hostlib.poseidon.hash_batch`, one
arity-4 hash per chunk): compression squeezes hundreds of times, and the
Python permutation :func:`..poseidon.host.hash_preimage`, which the JAX
transcript runs and which is the oracle here, is several times slower
(``scripts/torch_host_timings.py --hashes N`` times both).

Plays the role of arecibo's `PoseidonRO` (external crate): absorbs field
elements and curve points, squeezes ~250-bit challenges. Uses our
Neptune-parity Poseidon over the commitment curve's BASE field (point
coordinates live there) and truncates squeezed digests to 248 bits when
mapping into the scalar field (standard Nova practice keeps challenges
below both moduli).

Self-consistent across prove/verify; arecibo does not publish test
vectors offline, so bit-parity with its RO is out of scope (see
SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import List

from ..curves.weierstrass import Affine, Curve
from ..hostlib.poseidon import hash_batch

# 124 bits: small enough that an in-circuit nonnative product
# challenge x 128-bit-limb (2^252) stays below every cycle modulus
# (bn256 ~ 2^253.5, pasta ~ 2^254.5) — see r1cs/bignat.py — while
# keeping 124-bit Fiat-Shamir soundness (Nova uses 128).
CHALLENGE_BITS = 124


class Transcript:
    """Sponge-like transcript: absorb field elements, squeeze challenges."""

    def __init__(self, curve: Curve, domain: bytes):
        self.curve = curve
        self.base = curve.base
        self.state: int = int.from_bytes(
            domain.ljust(16, b"\0")[:16], "little")
        self._buf: List[int] = []

    def absorb(self, x: int) -> None:
        self._buf.append(x % self.base.modulus)

    def absorb_scalar(self, x: int) -> None:
        # Scalar-field values can exceed the base modulus (pallas/vesta:
        # q > p), so a mod-p reduction would alias distinct instance
        # values. Absorb losslessly as two limbs (low 128 bits, high
        # bits), mirroring Nova's limb-split scalar absorption.
        x = int(x)
        if self.curve.order > self.base.modulus:
            self._buf.append(x & ((1 << 128) - 1))
            self._buf.append(x >> 128)
        else:
            self._buf.append(x % self.base.modulus)

    def absorb_point(self, pt: Affine) -> None:
        if pt is None:
            self._buf.extend((0, 0, 1))
        else:
            self._buf.extend((pt[0], pt[1], 0))

    def _compress(self) -> None:
        """Fold the buffer into the state with arity-4 Poseidon chunks."""
        data = [self.state] + self._buf
        self._buf = []
        while len(data) > 1:
            chunk = data[:4]
            chunk += [0] * (4 - len(chunk))
            digest = hash_batch(self.base, 4, [chunk])[0]
            data = [digest] + data[4:]
        self.state = data[0]

    def squeeze(self) -> int:
        """~248-bit challenge, valid in both fields of the cycle."""
        self._buf.append(1)  # domain separation for squeeze
        self._compress()
        return self.state % (1 << CHALLENGE_BITS)
