"""Optimized Poseidon preprocessing: sparse partial-round matrices +
transported round constants (the Poseidon paper's Appendix-B
optimization, as shipped by neptune's preprocessing — public math).

Standard round r:  s_{r+1} = MDS @ sbox_r(s_r + c_r)
(partial rounds apply the S-box to element 0 only).

Matrix factorization over the partial chain: N = M' @ M'' with
M' = [[1, 0], [0, N_hat]] (dense on elements 1..t-1, fixes element 0)
and M'' = [[n00, w], [N_hat^{-1} v, I]] (sparse). sigma0 commutes
with M', so each round's dense factor pushes FORWARD into the next
round's matrix: the last first-half full round's mix becomes
sparse[0], partial round k < rp-1 applies sparse[k+1], and the
accumulated dense matrix lands on the LAST partial round
(`pre_sparse` — one dense apply per chain). In-chain constants ride
in the factored basis (carry^{-1} @ c) and their 1..t-1 components
transport forward through the factored matrices, leaving only
element-0 adds inside the chain.

Constants ride forward instead: in the add-after form
(u_{r+1} = Mx_r @ sbox(u_r) + k_r, u_0 = input + c_0), the 1..t-1
components of k_r are transparent to the next round's sbox0 and move
through that round's (optimized) matrix into k_{r+1}; one forward
sweep leaves only element-0 constants inside the partial chain.

Result (validated bit-exact vs poseidon.host by
tests/test_poseidon_opt.py): partial-round mix costs 2t-1 + (t-1)
muls instead of t^2 — the kernel-side lever for shrinking the
per-round MDS matmul ~5x on rp of the rounds (PERF.md ceiling case).

Matrix convention: column vectors, s' = M @ s with
M[i][j] = spec.mds[j][i] (poseidon.host computes
out[j] = sum_i mds[i][j] * st[i]).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Tuple

from ..fields import FieldSpec
from .spec import PoseidonSpec, poseidon_spec


def _mat_inv(m: List[List[int]], p: int) -> List[List[int]]:
    n = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % p)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], p - 2, p)
        a[col] = [(x * inv) % p for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % p for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_mul(a, b, p):
    n, k, m = len(a), len(b), len(b[0])
    return [[sum(a[i][x] * b[x][j] for x in range(k)) % p
             for j in range(m)] for i in range(n)]


def _mat_vec(m, v, p):
    return [sum(m[i][j] * v[j] for j in range(len(v))) % p
            for i in range(len(m))]


@dataclasses.dataclass(frozen=True)
class SparseMat:
    """M'' = [[m00, w (row)], [v_hat (col), I]]: apply costs t muls
    for element 0 plus t-1 muls for the rank-1 column update."""

    m00: int
    w: Tuple[int, ...]        # row 0, cols 1..t-1
    v_hat: Tuple[int, ...]    # col 0, rows 1..t-1

    def apply(self, s: List[int], p: int) -> List[int]:
        out0 = (self.m00 * s[0]
                + sum(w * x for w, x in zip(self.w, s[1:]))) % p
        return [out0] + [(s[i + 1] + self.v_hat[i] * s[0]) % p
                         for i in range(len(self.v_hat))]

    def as_matrix(self, t: int) -> List[List[int]]:
        m = [[1 if i == j else 0 for j in range(t)] for i in range(t)]
        m[0][0] = self.m00
        for j in range(1, t):
            m[0][j] = self.w[j - 1]
            m[j][0] = self.v_hat[j - 1]
        return m


@dataclasses.dataclass(frozen=True)
class OptPoseidonSpec:
    spec: PoseidonSpec
    pre_keys: Tuple[int, ...]           # added to the initial state
    post_keys: Tuple[Tuple[int, ...], ...]   # per-round post-mix adds;
    #   inside the partial chain only element 0 is nonzero
    pre_sparse: Tuple[Tuple[int, ...], ...]  # round rf/2-1's matrix
    sparse: Tuple[SparseMat, ...]       # one per partial round
    mds_col: Tuple[Tuple[int, ...], ...]


@lru_cache(maxsize=None)
def opt_poseidon_spec(field: FieldSpec, arity: int) -> OptPoseidonSpec:
    spec = poseidon_spec(field, arity)
    p = field.modulus
    t = spec.width
    rf_half = spec.full_rounds // 2
    rp = spec.partial_rounds
    n_rounds = spec.full_rounds + rp
    rc = [[spec.round_constants[r * t + i] % p for i in range(t)]
          for r in range(n_rounds)]
    M = [[spec.mds[j][i] % p for j in range(t)] for i in range(t)]

    # ---- factor the partial chain (forward) -------------------------
    # chain (execution): [M_0=M(full-round mix), sigma0, M, sigma0,
    # ..., M]. Factor N = M' @ M'' with M' = diag(1, N_hat) and
    # M'' = [[n00, w], [N_hat^{-1} v, I]]; sigma0 commutes with M',
    # so each M' pushes FORWARD into the next round's matrix. The
    # pre-chain full-round mix becomes SPARSE (B_0) and the dense
    # accumulation lands on the LAST partial round's matrix (B_rp).
    def _factor(N):
        n00 = N[0][0]
        w = [N[0][j] for j in range(1, t)]
        v = [N[i][0] for i in range(1, t)]
        N_hat = [[N[i][j] for j in range(1, t)] for i in range(1, t)]
        v_hat = _mat_vec(_mat_inv(N_hat, p), v, p)
        M_prime = [[1 if i == j else 0 for j in range(t)]
                   for i in range(t)]
        for i in range(1, t):
            for j in range(1, t):
                M_prime[i][j] = N_hat[i - 1][j - 1]
        return SparseMat(n00, tuple(w), tuple(v_hat)), M_prime

    sparse_list: List[SparseMat] = []
    carries: List[List[List[int]]] = []
    carry = None
    for _ in range(rp):
        N = M if carry is None else _mat_mul(M, carry, p)
        s_mat, carry = _factor(N)
        sparse_list.append(s_mat)
        carries.append(carry)
    chain_tail = _mat_mul(M, carry, p) if carry is not None else M
    # layout: round rf_half-1 (full) applies sparse_list[0]; partial
    # round k (0-based) applies sparse_list[k+1] for k < rp-1 and the
    # dense chain_tail for k = rp-1.
    pre_sparse = chain_tail     # kept name: the one DENSE chain matrix
    sparse = sparse_list

    # optimized per-round matrices, execution order
    def round_matrix(r) -> List[List[int]]:
        if r == rf_half - 1:
            return sparse[0].as_matrix(t)
        if rf_half <= r < rf_half + rp - 1:
            return sparse[r - rf_half + 1].as_matrix(t)
        if r == rf_half + rp - 1:
            return pre_sparse
        return M

    # ---- constants: add-after form + forward transport --------------
    pre_keys = list(rc[0])
    post = [list(rc[r + 1]) if r + 1 < n_rounds else [0] * t
            for r in range(n_rounds)]
    # In-chain constants ride in the FACTORED basis: after the round
    # at chain position i the factored state is carry_i^{-1} @ s_std
    # (carry_i = the not-yet-applied accumulated M'), so the standard
    # post-add c becomes carry_i^{-1} @ c. carry_i fixes element 0, so
    # the sigma0 input stays correct.
    for i in range(rp):            # chain positions with a carry
        r = rf_half - 1 + i        # round index (B_0 .. B_{rp-1})
        inv = _mat_inv(carries[i], p)
        post[r] = _mat_vec(inv, post[r], p)
    # Then: rounds r+1 in the partial chain have sbox0 only — the
    # 1..t-1 components of post[r] pass the sbox unchanged and move
    # through round r+1's (factored) matrix into post[r+1].
    for r in range(rf_half - 1, rf_half + rp - 1):
        lin = [0] + post[r][1:]
        if any(lin):
            moved = _mat_vec(round_matrix(r + 1), lin, p)
            post[r] = [post[r][0]] + [0] * (t - 1)
            post[r + 1] = [(a + b) % p
                           for a, b in zip(post[r + 1], moved)]

    return OptPoseidonSpec(
        spec=spec, pre_keys=tuple(pre_keys),
        post_keys=tuple(tuple(k) for k in post),
        pre_sparse=tuple(tuple(row) for row in pre_sparse),
        sparse=tuple(sparse),
        mds_col=tuple(tuple(row) for row in M))


def hash_preimage_opt(field: FieldSpec, preimage) -> int:
    """Optimized-path host evaluation — must match poseidon.host
    bit-exactly (pinned by tests/test_poseidon_opt.py)."""
    o = opt_poseidon_spec(field, len(preimage))
    spec = o.spec
    p = field.modulus
    t = spec.width
    rf_half = spec.full_rounds // 2
    rp = spec.partial_rounds
    n_rounds = spec.full_rounds + rp

    def sbox(x):
        x2 = x * x % p
        return x2 * x2 % p * x % p

    s = [(v + k) % p
         for v, k in zip([spec.domain_tag % p,
                          *[x % p for x in preimage]], o.pre_keys)]
    for r in range(n_rounds):
        if rf_half <= r < rf_half + rp:
            s[0] = sbox(s[0])
            k = r - rf_half
            if k < rp - 1:
                s = o.sparse[k + 1].apply(s, p)
            else:
                s = _mat_vec([list(row) for row in o.pre_sparse], s, p)
        else:
            s = [sbox(x) for x in s]
            if r == rf_half - 1:
                s = o.sparse[0].apply(s, p)
            else:
                s = _mat_vec([list(row) for row in o.mds_col], s, p)
        s = [(x + k) % p for x, k in zip(s, o.post_keys[r])]
    return s[1]
