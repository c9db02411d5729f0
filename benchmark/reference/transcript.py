"""The proofs' Fiat-Shamir transcript on Python integers, as the port
publishes it (``lurk_tpu_torch/proof/transcript.py``): a state of one
element of the commitment curve's base field, started from the domain's
first 16 bytes read little-endian; absorbed elements wait in a buffer;
a squeeze appends 1 and folds [state] + buffer with arity-4 Poseidon
(chunks of four, zero-padded, each digest the next chunk's head), and
returns the state's low 124 bits. A point goes in as (x, y, 0), the
identity as (0, 0, 1); a scalar of a field wider than the base field as
its low 128 bits and the rest.
"""

from __future__ import annotations

from typing import List

from .curve import Affine, Curve
from .poseidon import hasher

CHALLENGE_BITS = 124


class Transcript:
    def __init__(self, curve: Curve, domain: bytes):
        self.p = curve.p
        self.split = curve.order > curve.p
        self.state = int.from_bytes(domain.ljust(16, b"\0")[:16], "little")
        self.buf: List[int] = []
        self.h = hasher(self.p, 4)

    def absorb(self, x: int) -> None:
        self.buf.append(x % self.p)

    def absorb_scalar(self, x: int) -> None:
        x = int(x)
        if self.split:
            self.buf += [x & ((1 << 128) - 1), x >> 128]
        else:
            self.buf.append(x % self.p)

    def absorb_point(self, pt: Affine) -> None:
        self.buf += [0, 0, 1] if pt is None else [pt[0], pt[1], 0]

    def squeeze(self) -> int:
        data = [self.state] + self.buf + [1]
        self.buf = []
        while len(data) > 1:
            chunk = (data[:4] + [0, 0, 0])[:4]
            data = [self.h.hash(chunk)] + data[4:]
        self.state = data[0]
        return self.state % (1 << CHALLENGE_BITS)


def absorb_relaxed(tr: Transcript, inst) -> None:
    """A relaxed instance (comm_w, comm_e, x, u)."""
    comm_w, comm_e, x, u = inst
    tr.absorb_point(comm_w)
    tr.absorb_point(comm_e)
    tr.absorb_scalar(u)
    for v in x:
        tr.absorb_scalar(v)
