"""Multilinear-extension helpers over a prime field (host side).

From the JAX package's ``proof/mle.py``: the sumcheck verifier and its
Lagrange interpolation, and the power-of-two padding. The Spartan
prover (:mod:`.spartan`) runs its sumchecks, chi tables and MLE
evaluations through the host C++ (:mod:`..hostlib.spartan`), which the
tests hold against the JAX package's Python versions.

Functionality parity target: arecibo's `spartan::sumcheck` (external
crate driven by reference src/proof/nova.rs:232-251 `CompressedSNARK`).

Convention: an array `a` of length 2^k represents the MLE
a~(r_0..r_{k-1}) where r_0 binds the MOST significant index bit — i.e.
binding r_0 folds the second half onto the first:
    a'[i] = a[i] + r_0 * (a[i + 2^(k-1)] - a[i]).
The chi tables of the host C++ and the IPA fold (ipa.py) use the same
order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_pow2(vec: Sequence[int], n: int) -> List[int]:
    out = list(vec)
    assert len(out) <= n
    out.extend([0] * (n - len(out)))
    return out


def lagrange_eval(evals: Sequence[int], t: int, p: int) -> int:
    """Evaluate the degree-(len-1) polynomial with values evals[j] at
    j = 0..len-1, at point t (Lagrange interpolation)."""
    n = len(evals)
    acc = 0
    for j in range(n):
        num, den = 1, 1
        for m in range(n):
            if m == j:
                continue
            num = num * (t - m) % p
            den = den * (j - m) % p
        acc = (acc + evals[j] * num * pow(den, -1, p)) % p
    return acc


# ---------------------------------------------------------------------------
# The sumcheck verifier
# ---------------------------------------------------------------------------


def sumcheck_verify(
    claim: int,
    round_polys: List[List[int]],
    degree: int,
    p: int,
    challenge: Callable[[Sequence[int]], int],
) -> Tuple[int, List[int]]:
    """Walk the round polynomials; returns (final_claim, challenges).

    Raises ValueError on a malformed round (degree or sum check)."""
    e = claim % p
    rs: List[int] = []
    for evals in round_polys:
        if len(evals) != degree + 1:
            raise ValueError("sumcheck round poly has wrong degree")
        if (evals[0] + evals[1]) % p != e:
            raise ValueError("sumcheck round sum mismatch")
        r = challenge(evals)
        rs.append(r)
        e = lagrange_eval(evals, r, p)
    return e, rs
