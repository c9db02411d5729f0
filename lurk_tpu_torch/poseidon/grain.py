"""Grain-LFSR round-constant generation for Poseidon, Neptune-compatible.

Re-implements the constant-generation scheme of the Poseidon paper's
``generate_parameters_grain.sage`` as used by the ``neptune`` crate
(the reference's Poseidon provider; see reference src/hash.rs:60-83
for how Lurk instantiates ``PoseidonConstants::new()`` per arity).

The LFSR state is 80 bits seeded with (field, sbox, n, t, R_F, R_P, 1^30);
output bits are produced in a self-shrinking mode: bits are consumed in
non-overlapping pairs, the second bit of a pair is emitted iff the first
bit is 1. Round-constant candidates take ``n`` bits MSB-first and are
rejection-sampled against the field modulus.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

_STATE_BITS = 80
_TAPS = (62, 51, 38, 23, 13, 0)
_CHUNK = 18                 # bits per step: s[k+80] needs s[k..k+62] only
_CHUNKS_PER_BLOCK = 4096


class GrainLFSR:
    """80-bit Grain LFSR in self-shrinking mode.

    The state is an int whose bit i is s[i] (bit 0 the oldest). Since the
    newest tap is s[62], the next 18 bits s[80..97] are one word
    operation: the XOR of the state shifted by each tap."""

    def __init__(self, field_code: int, sbox_code: int, n: int, t: int,
                 r_f: int, r_p: int):
        bits: List[int] = []
        _append_bits(bits, 2, field_code)
        _append_bits(bits, 4, sbox_code)
        _append_bits(bits, 12, n)
        _append_bits(bits, 12, t)
        _append_bits(bits, 10, r_f)
        _append_bits(bits, 10, r_p)
        _append_bits(bits, 30, (1 << 30) - 1)
        assert len(bits) == _STATE_BITS
        self._state = sum(b << i for i, b in enumerate(bits))
        self._out = np.zeros(0, dtype=np.uint8)     # filtered, unread
        # 160 warm-up clocks, outputs discarded.
        self._refill(skip=160)

    def _refill(self, skip: int = 0) -> None:
        """Clock one block of raw bits, drop the first ``skip`` and append
        the self-shrinking output: of each pair, the second bit when the
        first is 1."""
        s, mask, words = self._state, (1 << _CHUNK) - 1, []
        for _ in range(_CHUNKS_PER_BLOCK):
            w = 0
            for tap in _TAPS:
                w ^= s >> tap
            w &= mask
            words.append(w)
            s = (s >> _CHUNK) | (w << (_STATE_BITS - _CHUNK))
        self._state = s
        raw = (np.array(words, dtype=np.uint32)[:, None]
               >> np.arange(_CHUNK, dtype=np.uint32)) & 1
        pairs = raw.reshape(-1)[skip:].astype(np.uint8).reshape(-1, 2)
        self._out = np.concatenate([self._out, pairs[pairs[:, 0] == 1, 1]])

    def next_bits(self, n: int) -> List[int]:
        while len(self._out) < n:
            self._refill()
        bits, self._out = self._out[:n], self._out[n:]
        return bits.tolist()

    def field_elements(self, modulus: int, n_bits: int,
                       count: int) -> Iterator[int]:
        """Yield ``count`` uniformly sampled field elements: ``n_bits``
        filtered bits MSB-first per candidate, rejection-sampled < modulus."""
        for _ in range(count):
            while True:
                v = int("".join(map(str, self.next_bits(n_bits))), 2)
                if v < modulus:
                    yield v
                    break


def _append_bits(out: List[int], width: int, value: int) -> None:
    for i in range(width - 1, -1, -1):
        out.append((value >> i) & 1)


def generate_round_constants(modulus: int, n_bits: int, t: int, r_f: int,
                             r_p: int, field_code: int = 1,
                             sbox_code: int = 0) -> List[int]:
    """All (r_f + r_p) * t round constants, in generation order."""
    lfsr = GrainLFSR(field_code, sbox_code, n_bits, t, r_f, r_p)
    return list(lfsr.field_elements(modulus, n_bits, (r_f + r_p) * t))
