"""What each configuration's program must give, from its definition.

- ``fib_pair``: the Fibonacci stream ``(next a b)`` (lurk-beta
  ``benches/common/fib.rs``) after its frames holds, of all numbers, only
  F_i and F_i+1 of the pair (F_0 = a, F_1 = b): the configuration names
  the indices (fib(n)'s frames are 7 + 7n, so 800 frames are 113
  iterations and two frames of the next: F_113 and F_114).
- ``sha256_of_args``: ``(sha256_nivc_n x ..)`` (lurk-beta
  ``src/coprocessor/sha256.rs``) gives the number whose bits are the
  sha256 of the arguments' (tag, digest) pairs, 32 little-endian bytes
  each, the whole buffer reversed, the big-endian digest cut to the
  field's 253-bit capacity. A number's digest is the number.
"""

from __future__ import annotations

import hashlib
from typing import List

# Lurk's expression tags (lurk-beta src/tag.rs: ExprTag), as field
# elements
NUM_TAG = 4
CAPACITY_BITS = 253


def fib(a: int, b: int, i: int, p: int) -> int:
    for _ in range(i):
        a, b = b, (a + b) % p
    return a % p


def expected_numbers(result: dict, inputs: List[int], p: int) -> set:
    if result["kind"] == "fib_pair":
        a, b = inputs
        return {fib(a, b, i, p) for i in result["indices"]}
    if result["kind"] == "sha256_of_args":
        buf = bytearray()
        for x in inputs:
            buf += NUM_TAG.to_bytes(32, "little")
            buf += (x % p).to_bytes(32, "little")
        buf.reverse()
        v = int.from_bytes(hashlib.sha256(bytes(buf)).digest(), "big")
        return {v & ((1 << CAPACITY_BITS) - 1)}
    raise ValueError(f"unknown result kind {result['kind']!r}")
