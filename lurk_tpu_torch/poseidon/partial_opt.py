"""Optimized partial-round schedule for Poseidon (constant-folded linear layers).

During the partial-round span only element 0 passes through the S-box;
the rest of the state evolves affinely. Folding the affine part gives a
per-round scalar recurrence over the S-box outputs:

    u_j[0] = alpha_{j-a} . s_a  +  beta_j  +  sum_q gamma_{j-1-q} delta_q

with delta_q = u_q[0]^5 the q-th S-box output, s_a the state entering the
partial span, and all greek quantities CONSTANT (precomputed mod p):

    N       = M^T (I - e0 e0^T)      (the linear layer sans the sboxed lane)
    alpha_d = row 0 of N^d
    gamma_d = (N^d m0)[0],  m0 = M^T e0
    beta_j  = c_j[0] + sum_{q<j} (N^{j-1-q} (M^T(I-e0e0^T) c_q))[0]

and the state leaving the span is one affine reconstruction

    s_{a+rp} = A s_a + B + sum_d W_d delta_{a+rp-1-d},   A = N^rp, W_d = N^d m0.

gamma depends only on the round DISTANCE d — the per-round dot over past
S-box outputs is a sliding window with one shared coefficient table.
Functionality parity: neptune's sparse-matrix partial-round optimization
(the reference's Poseidon backend); same digests, different
factorization. A copy of the JAX package's ``poseidon/partial_opt.py``;
:func:`lurk_tpu_torch.poseidon.kernel.folded_constants` lays these
tables out for the folded CUDA kernel (``csrc/poseidon_folded.cu``).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Tuple

from ..fields import FieldSpec
from .spec import poseidon_spec


def _matmul(field: FieldSpec, m, v_or_m):
    p = field.modulus
    if isinstance(v_or_m[0], (list, tuple)):
        n = len(v_or_m[0])
        return [[sum(m[i][k] * v_or_m[k][j] for k in range(len(v_or_m)))
                 % p for j in range(n)] for i in range(len(m))]
    return [sum(m[i][k] * v_or_m[k] for k in range(len(v_or_m))) % p
            for i in range(len(m))]


@dataclasses.dataclass(frozen=True)
class PartialSchedule:
    """Constant tables for the folded partial span (all values mod p)."""

    a: int                       # first partial round index
    rp: int                      # number of partial rounds
    alpha: Tuple[Tuple[int, ...], ...]   # [rp][t]  row-0 of N^d
    beta: Tuple[int, ...]                # [rp]     per-round scalar
    gamma: Tuple[int, ...]               # [rp]     delta coefficient at distance d+...
    # reconstruction of the state leaving the span:
    a_mat: Tuple[Tuple[int, ...], ...]   # [t][t]   A = N^rp
    b_vec: Tuple[int, ...]               # [t]
    w_mat: Tuple[Tuple[int, ...], ...]   # [t][rp]  column q is N^{rp-1-q} m0


@lru_cache(maxsize=None)
def partial_schedule(field: FieldSpec, arity: int) -> PartialSchedule:
    spec = poseidon_spec(field, arity)
    p = field.modulus
    t = spec.width
    a = spec.full_rounds // 2
    rp = spec.partial_rounds
    # M^T with spec orientation out[j] = sum_i M[i][j] x[i]
    mt = [[spec.mds[i][j] for i in range(t)] for j in range(t)]
    n_mat = [[mt[j][i] if i != 0 else 0 for i in range(t)]
             for j in range(t)]
    m0 = [mt[j][0] for j in range(t)]
    rc = [spec.round_constants[r * t:(r + 1) * t]
          for r in range(spec.full_rounds + spec.partial_rounds)]

    # powers of N applied to m0 and row-0 extraction
    npow_m0: List[List[int]] = [m0]
    for _ in range(rp - 1):
        npow_m0.append(_matmul(field, n_mat, npow_m0[-1]))
    gamma = tuple(v[0] % p for v in npow_m0)

    # alpha_d = row 0 of N^d; track v^T N^d by iterating v^T <- v^T N
    alpha: List[Tuple[int, ...]] = []
    row = [1 if i == 0 else 0 for i in range(t)]
    for _ in range(rp):
        alpha.append(tuple(row))
        row = [sum(row[k] * n_mat[k][i] for k in range(t)) % p
               for i in range(t)]
    a_mat_rows = []   # N^rp rows via repeated row-vector iteration
    for r0 in range(t):
        rr = [1 if i == r0 else 0 for i in range(t)]
        for _ in range(rp):
            rr = [sum(rr[k] * n_mat[k][i] for k in range(t)) % p
                  for i in range(t)]
        a_mat_rows.append(tuple(rr))

    # k_q = N c_q? NO: k_q = M^T (I - e0 e0^T) c_q = N c_q  (same matrix)
    k = [_matmul(field, n_mat, list(rc[a + q])) for q in range(rp)]
    # beta_j for j in the span (relative index r = j - a)
    # beta_r = c_{a+r}[0] + sum_{q<r} (N^{r-1-q} k_q)[0]
    # iterate acc_r = sum_{q<r} N^{r-1-q} k_q:  acc_{r+1} = N acc_r + k_r
    beta: List[int] = []
    acc = [0] * t
    for r in range(rp):
        beta.append((rc[a + r][0] + acc[0]) % p)
        acc = [(x + y) % p
               for x, y in zip(_matmul(field, n_mat, acc), k[r])]
    # b_vec = acc after all rp rounds (state-space constant term)
    b_vec = tuple(acc)

    # w_mat column q = N^{rp-1-q} m0
    w_cols = [npow_m0[rp - 1 - q] for q in range(rp)]
    w_mat = tuple(tuple(w_cols[q][i] for q in range(rp)) for i in range(t))

    return PartialSchedule(
        a=a, rp=rp, alpha=tuple(alpha), beta=tuple(beta), gamma=gamma,
        a_mat=tuple(a_mat_rows), b_vec=b_vec, w_mat=w_mat)


def run_partial_span_host(field: FieldSpec, arity: int,
                          state: List[int]) -> List[int]:
    """Host oracle: apply the folded schedule to `state` (the state
    entering the first partial round). Must agree bit-exactly with the
    naive per-round loop."""
    sched = partial_schedule(field, arity)
    spec = poseidon_spec(field, arity)
    p = field.modulus
    t = spec.width
    deltas: List[int] = []
    for r in range(sched.rp):
        u0 = sum(sched.alpha[r][i] * state[i] for i in range(t)) \
            + sched.beta[r]
        u0 += sum(sched.gamma[r - 1 - q] * deltas[q] for q in range(r))
        u0 %= p
        deltas.append(pow(u0, 5, p))
    out = []
    for i in range(t):
        v = sum(sched.a_mat[i][j] * state[j] for j in range(t)) \
            + sched.b_vec[i] \
            + sum(sched.w_mat[i][q] * deltas[q] for q in range(sched.rp))
        out.append(v % p)
    return out
