"""Neptune's Poseidon (the hash of Lurk's store and transcripts) on
Python integers, from its public definition.

Round numbers: neptune's ``round_numbers.rs`` (security level 128, the
paper's bounds at a 255-bit prime, then R_F + 2 and R_P x 1.075 rounded
up). Round constants: the Poseidon paper's Grain LFSR
(``generate_parameters_grain.sage``) seeded with (field 1, S-box 1,
NUM_BITS, t, R_F, R_P, 1^30), self-shrinking, candidates MSB-first and
rejected at or above the modulus. MDS: the Cauchy matrix 1 / (x_i + y_j),
x = 0..t-1, y = t..2t-1, applied as state'_j = sum_i M[i][j] state_i.
Domain tag 2^arity - 1 (neptune's ``HashType::MerkleTree``); the digest
is state[1]. Anchored by the Rust reference's own digests in
``benchmark/tests/test_bench_reference.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple


def _secure(t: int, rf: int, rp: int) -> bool:
    n, m = 255.0, 128.0
    rf_stat = 6.0 if m <= (n - 3.0) * (t + 1.0) else 10.0
    return rf >= max(math.ceil(rf_stat),
                     math.ceil(0.43 * m + math.log2(t) - rp),
                     math.ceil(0.21 * n - rp),
                     math.ceil((0.14 * n - 1.0 - rp) / (t - 1.0)))


@lru_cache(maxsize=None)
def round_numbers(t: int) -> Tuple[int, int]:
    """(R_F, R_P) of width ``t``, with neptune's safety margin."""
    best = min((t * rf + rp, rf, rp) for rf in range(2, 101, 2)
               for rp in range(4, 201) if _secure(t, rf, rp))
    return best[1] + 2, math.ceil(1.075 * best[2])


def _grain_constants(modulus: int, n_bits: int, t: int, rf: int,
                     rp: int) -> List[int]:
    """The round constants in generation order. The 80-bit LFSR's state
    is an integer whose bit i is s[i] (bit 0 the oldest); the newest tap
    is s[62], so 18 new bits s[80..97] come from one XOR of shifts."""
    bits = []
    for value, width in [(1, 2), (1, 4), (n_bits, 12), (t, 12), (rf, 10),
                         (rp, 10), ((1 << 30) - 1, 30)]:
        bits += [(value >> i) & 1 for i in range(width - 1, -1, -1)]
    state = sum(b << i for i, b in enumerate(bits))
    raw: List[int] = []

    def refill():
        nonlocal state
        w = (state ^ (state >> 13) ^ (state >> 23) ^ (state >> 38)
             ^ (state >> 51) ^ (state >> 62)) & 0x3FFFF
        state = (state >> 18) | (w << 62)
        raw.extend((w >> i) & 1 for i in range(18))

    while len(raw) < 160:           # the warm-up clocks, discarded
        refill()
    del raw[:160]
    out: List[int] = []             # self-shrinking: of each pair, the
    consts: List[int] = []          # second bit when the first is 1
    while len(consts) < (rf + rp) * t:
        while len(out) < n_bits:
            while len(raw) < 2 * 18:
                refill()
            out.extend(raw[k + 1] for k in range(0, len(raw) - 1, 2)
                       if raw[k])
            del raw[:len(raw) - len(raw) % 2]
        v = int("".join(map(str, out[:n_bits])), 2)
        del out[:n_bits]
        if v < modulus:
            consts.append(v)
    return consts


class Poseidon:
    """Constant-length Poseidon of one arity over one prime field."""

    def __init__(self, modulus: int, arity: int):
        p = self.p = modulus
        t = self.t = arity + 1
        self.rf, self.rp = round_numbers(t)
        self.rc = _grain_constants(p, p.bit_length(), t, self.rf, self.rp)
        self.mds = [[pow(x + y, p - 2, p) for y in range(t, 2 * t)]
                    for x in range(t)]
        self.tag = (1 << arity) - 1

    def hash(self, preimage: Sequence[int]) -> int:
        p, t, mds, rc = self.p, self.t, self.mds, self.rc
        if len(preimage) != t - 1:
            raise ValueError(f"{len(preimage)} inputs to arity {t - 1}")
        st = [self.tag] + [x % p for x in preimage]
        off = 0
        cols = [[mds[i][j] for i in range(t)] for j in range(t)]
        half = self.rf // 2
        for r in range(self.rf + self.rp):
            st = [(s + c) for s, c in zip(st, rc[off:off + t])]
            off += t
            if r < half or r >= half + self.rp:
                st = [pow(s, 5, p) for s in st]
            else:
                st[0] = pow(st[0], 5, p)
            st = [sum(m * s for m, s in zip(col, st)) % p for col in cols]
        return st[1]


@lru_cache(maxsize=None)
def hasher(modulus: int, arity: int) -> Poseidon:
    return Poseidon(modulus, arity)


def poseidon_hash(modulus: int, preimage: Sequence[int]) -> int:
    return hasher(modulus, len(preimage)).hash(preimage)
