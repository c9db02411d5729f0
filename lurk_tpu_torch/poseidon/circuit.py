"""Poseidon hash as R1CS constraints.

A copy of the JAX package's ``poseidon/circuit.py``. Replaces neptune's
`circuit2::poseidon_hash_allocated` (reference src/lem/circuit.rs:34,
221-240) with a direct synthesis of the unoptimized-but-equivalent
permutation over :mod:`lurk_tpu_torch.r1cs.cs`: round constants and the
MDS mix stay inside linear combinations (free), each S-box costs exactly
3 constraints/aux (x2 = x*x, x4 = x2*x2, x5 = x4*x).

The aux layout is deterministic — for each round, for each S-boxed lane:
x2, x4, x5 — so the host C++ (``csrc/host/poseidon.cpp``) generates the
identical witness trace (see :func:`witness_trace_and_digest`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..fields import FieldSpec
from ..r1cs.cs import lc_add
from ..r1cs.gadgets import ConstraintSystem, Num, mul
from .partial_opt import partial_schedule
from .spec import poseidon_spec


def _sbox(cs: ConstraintSystem, x: Num) -> Num:
    x2 = mul(cs, x, x)
    x4 = mul(cs, x2, x2)
    return mul(cs, x4, x)


def _combine(terms: Sequence[Tuple[int, Num]], const: int, p: int) -> Num:
    """sum coeff * x over ``terms`` plus ``const`` as one linear
    combination, summed in one dictionary and reduced once."""
    acc: Dict[int, int] = {ConstraintSystem.ONE_VAR: const} if const else {}
    val = const
    for coeff, x in terms:
        val += coeff * x.value
        for var, c in x.lc.items():
            acc[var] = acc.get(var, 0) + coeff * c
    lc = {}
    for var, c in acc.items():
        c %= p
        if c:
            lc[var] = c
    return Num(lc, val % p)


def poseidon_circuit(cs: ConstraintSystem, field: FieldSpec,
                     preimage: Sequence[Num]) -> Num:
    """Constrain the Neptune-compatible constant-length hash of
    ``len(preimage)`` elements; returns the digest as an (unallocated) LC.

    The constraints, aux and linear combinations are the JAX package's.
    Only their algebra differs: the partial span's S-box inputs and the
    state leaving it are built from the folded tables of
    :func:`.partial_opt.partial_schedule` (the same linear forms, as
    ``u_r = alpha_r . s_a + beta_r + sum_q gamma_{r-1-q} delta_q`` is an
    identity in the variables), not by carrying combinations that grow
    by a term a round through every round's MDS."""
    spec = poseidon_spec(field, len(preimage))
    sched = partial_schedule(field, len(preimage))
    p = cs.p
    t = spec.width
    rc = spec.round_constants
    half_full = spec.full_rounds // 2

    def full_round(st: List[Num], off: int) -> List[Num]:
        st = [_sbox(cs, Num(lc_add(x.lc, {ConstraintSystem.ONE_VAR:
                                          rc[off + i] % p}, p),
                            (x.value + rc[off + i]) % p))
              for i, x in enumerate(st)]
        return [_combine([(spec.mds[i][j], st[i]) for i in range(t)], 0, p)
                for j in range(t)]

    state: List[Num] = [Num.constant(cs, spec.domain_tag), *preimage]
    for r in range(half_full):
        state = full_round(state, r * t)
    deltas: List[Num] = []
    for r in range(sched.rp):
        u = _combine([*zip(sched.alpha[r], state),
                      *((sched.gamma[r - 1 - q], deltas[q])
                        for q in range(r))], sched.beta[r], p)
        deltas.append(_sbox(cs, u))
    state = [_combine([*zip(sched.a_mat[i], state),
                       *zip(sched.w_mat[i], deltas)], sched.b_vec[i], p)
             for i in range(t)]
    for r in range(half_full + sched.rp, spec.full_rounds + sched.rp):
        state = full_round(state, r * t)
    return state[1]


def poseidon_witness(cs: ConstraintSystem, field: FieldSpec,
                     preimage: Sequence[Num]) -> Num:
    """Witness-only path (neptune circuit2_witness
    `poseidon_hash_allocated_witness` parity, reference src/circuit/
    gadgets/hashes.rs:6): pushes the identical aux trace as
    :func:`poseidon_circuit` (values only, no linear-combination algebra
    — the dominant cost of full synthesis), computed by the host C++,
    and returns the digest value. Only valid on a ``witness_only``
    ConstraintSystem."""
    if not cs.witness_only:
        raise ValueError("poseidon_witness needs a witness-only system")
    from ..hostlib import poseidon as hpos
    trace, digest = hpos.witness_trace_and_digest(
        field, [x.value for x in preimage])
    cs.aux.extend(trace)
    return Num({}, digest)


def witness_trace_and_digest(field: FieldSpec,
                             preimage: Sequence[int]):
    """Plain oracle for the aux trace of :func:`poseidon_circuit` in
    allocation order, and the digest; the host C++ must reproduce it."""
    spec = poseidon_spec(field, len(preimage))
    p = field.modulus
    t = spec.width
    rc = spec.round_constants
    half_full = spec.full_rounds // 2
    state = [spec.domain_tag, *[x % p for x in preimage]]
    off = 0
    trace: List[int] = []

    def sbox(x: int) -> int:
        x2 = x * x % p
        x4 = x2 * x2 % p
        x5 = x4 * x % p
        trace.extend((x2, x4, x5))
        return x5

    def mds(st):
        return [sum(spec.mds[i][j] * st[i] for i in range(t)) % p
                for j in range(t)]

    for _ in range(half_full):
        state = [(x + rc[off + i]) % p for i, x in enumerate(state)]
        off += t
        state = mds([sbox(x) for x in state])
    for _ in range(spec.partial_rounds):
        state = [(x + rc[off + i]) % p for i, x in enumerate(state)]
        off += t
        state[0] = sbox(state[0])
        state = mds(state)
    for _ in range(half_full):
        state = [(x + rc[off + i]) % p for i, x in enumerate(state)]
        off += t
        state = mds([sbox(x) for x in state])
    return trace, state[1]
