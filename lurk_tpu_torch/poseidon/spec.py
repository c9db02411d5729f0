"""Poseidon parameter specs (round numbers, MDS, domain tags) — Neptune parity.

Round-number selection re-derives neptune's ``round_numbers.rs``: security
level M = 128 with the paper's simplified bounds, minimizing S-box count and
applying the safety margin (R_F += 2, R_P *= 1.075 rounded up). Verified
against neptune's published table: arity 2 -> (8, 55), 4 -> (8, 56),
8 -> (8, 57), 16 -> (8, 59).

The MDS matrix is the Cauchy matrix M[i][j] = 1/(x_i + y_j) with
x = 0..t-1, y = t..2t-1 (neptune mds.rs), applied as state' = M^T state
(neptune's product_mds iterates result[j] = sum_i M[i][j] state[i]).

Domain tag mirrors neptune HashType::MerkleTree: 2^arity - 1. The full
parameterization (grain seed sbox=1, n = F::NUM_BITS, MSB-first candidate
bits, partial-round S-box on element 0, digest = state[1]) was validated
bit-exactly against the reference commitment anchor
(src/lem/store.rs:1473) and trie-root anchors (src/coprocessor/trie).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import List, Tuple

from ..fields import FieldSpec
from .grain import generate_round_constants

# Security level (bits) and modeled modulus bit length, as hardcoded by
# neptune round_numbers.rs (M = 128, PRIME_BITLEN = 255 for all fields).
_M = 128.0
_PRIME_BITLEN = 255.0


def _round_numbers_are_secure(t: int, rf: int, rp: int) -> bool:
    n, m, tt, rp_f = _PRIME_BITLEN, _M, float(t), float(rp)
    rf_stat = 6.0 if m <= (n - 3.0) * (tt + 1.0) else 10.0
    rf_interp = 0.43 * m + math.log2(tt) - rp_f
    rf_grob_1 = 0.21 * n - rp_f
    rf_grob_2 = (0.14 * n - 1.0 - rp_f) / (tt - 1.0)
    rf_max = max(
        math.ceil(rf_stat), math.ceil(rf_interp),
        math.ceil(rf_grob_1), math.ceil(rf_grob_2),
    )
    return rf >= rf_max


@lru_cache(maxsize=None)
def calc_round_numbers(t: int, security_margin: bool = True) -> Tuple[int, int]:
    """Minimal (R_F, R_P) under the security bounds, minimizing S-boxes."""
    best = None
    for rf in range(2, 1001, 2):
        for rp in range(4, 201):
            if _round_numbers_are_secure(t, rf, rp):
                n_sboxes = t * rf + rp
                if best is None or n_sboxes < best[0]:
                    best = (n_sboxes, rf, rp)
    assert best is not None
    _, rf, rp = best
    if security_margin:
        rf += 2
        rp = math.ceil(1.075 * rp)
    return rf, rp


def cauchy_mds(field: FieldSpec, t: int) -> List[List[int]]:
    xs = list(range(t))
    ys = list(range(t, 2 * t))
    return [[field.inv(x + y) for y in ys] for x in xs]


@dataclasses.dataclass(frozen=True)
class PoseidonSpec:
    """Fully-resolved Poseidon instance for one (field, arity)."""

    field: FieldSpec
    arity: int
    width: int
    full_rounds: int
    partial_rounds: int
    domain_tag: int
    round_constants: Tuple[int, ...]   # (full+partial) * width, generation order
    mds: Tuple[Tuple[int, ...], ...]   # t x t Cauchy matrix

    @property
    def alpha(self) -> int:
        return 5


@lru_cache(maxsize=None)
def poseidon_spec(field: FieldSpec, arity: int) -> PoseidonSpec:
    t = arity + 1
    rf, rp = calc_round_numbers(t)
    rcs = generate_round_constants(
        field.modulus, field.num_bits, t, rf, rp, field_code=1, sbox_code=1,
    )
    mds = cauchy_mds(field, t)
    # Neptune HashType::MerkleTree domain tag: 2^arity - 1 (verified against
    # the reference commitment anchor, src/lem/store.rs:1473).
    domain_tag = ((1 << arity) - 1) % field.modulus
    return PoseidonSpec(
        field=field,
        arity=arity,
        width=t,
        full_rounds=rf,
        partial_rounds=rp,
        domain_tag=domain_tag,
        round_constants=tuple(rcs),
        mds=tuple(tuple(row) for row in mds),
    )
