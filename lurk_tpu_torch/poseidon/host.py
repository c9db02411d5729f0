"""Host (pure-Python) Poseidon — the bit-exactness reference.

Implements the unoptimized ("Correct") Poseidon permutation exactly as the
paper specifies and as neptune's correct path evaluates it: per round,
add round constants, apply the S-box (all elements in full rounds, element 0
in partial rounds), then multiply by the MDS matrix. The digest is state[1]
after the permutation, with initial state [domain_tag, preimage...].

Used by the Store for interactive hashing of small batches and by tests as
the oracle for the batched hasher (lurk_tpu_torch.poseidon.kernel).
"""

from __future__ import annotations

from typing import List, Sequence

from ..fields import FieldSpec
from .spec import PoseidonSpec, poseidon_spec


def permute(spec: PoseidonSpec, state: Sequence[int]) -> List[int]:
    p = spec.field.modulus
    t = spec.width
    assert len(state) == t
    st = [s % p for s in state]
    rc = spec.round_constants
    mds = spec.mds
    half_full = spec.full_rounds // 2
    off = 0

    def mds_mul(v: List[int]) -> List[int]:
        # result[j] = sum_i M[i][j] * v[i]  (neptune product_mds orientation)
        return [
            sum(mds[i][j] * v[i] for i in range(t)) % p for j in range(t)
        ]

    def full_round(v: List[int], off: int) -> int:
        for i in range(t):
            v[i] = (v[i] + rc[off + i]) % p
        for i in range(t):
            x2 = v[i] * v[i] % p
            v[i] = x2 * x2 % p * v[i] % p
        return off + t

    def partial_round(v: List[int], off: int) -> int:
        for i in range(t):
            v[i] = (v[i] + rc[off + i]) % p
        x2 = v[0] * v[0] % p
        v[0] = x2 * x2 % p * v[0] % p
        return off + t

    for _ in range(half_full):
        off = full_round(st, off)
        st = mds_mul(st)
    for _ in range(spec.partial_rounds):
        off = partial_round(st, off)
        st = mds_mul(st)
    for _ in range(half_full):
        off = full_round(st, off)
        st = mds_mul(st)
    assert off == len(rc)
    return st


def hash_preimage(field: FieldSpec, preimage: Sequence[int]) -> int:
    """Neptune-compatible constant-length hash of ``len(preimage)`` elements."""
    spec = poseidon_spec(field, len(preimage))
    state = [spec.domain_tag, *[x % field.modulus for x in preimage]]
    return permute(spec, state)[1]
