"""Inner-product argument (IPA) polynomial-commitment opening.

A copy of the JAX package's ``proof/ipa.py``. Every MSM of at least 64
scalars (each round's L and R over the original basis, and the
verifier's G_final) goes to the host Pippenger (:mod:`..hostlib.msm`,
``csrc/host/msm.cpp``), the JAX package's route for the round MSMs; a
smaller one to ``Curve.pippenger``. The JAX verifier computes G_final
with ``Curve.pippenger`` at every size: the same point.

Functionality parity target: arecibo's `provider::ipa_pc::
EvaluationEngine` — the PCS used by the reference's Pallas/Vesta
CompressedSNARK (reference src/proof/nova.rs:56-60 wires
`EvaluationEngine<E>` as EE1/EE2). Engine wiring matches the
reference: BN256 proofs open through HyperKZG (proof/hyperkzg.py,
pairing-verified); IPA serves the pasta curves and the grumpkin
secondary (which have no pairing).

Protocol (Bulletproofs-style, no zero-knowledge blinding — matching the
reference, whose Nova instantiation is also non-hiding): prove
<a, b> = c where P = <a, G> is a Pedersen vector commitment, b is a
public vector (for MLE opening: the chi table of the evaluation point).

    U = x * Q                      (x = transcript challenge, Q fixed)
    P_0 = P + c * U
    round j: L = <a_lo, G_hi> + <a_lo, b_hi> U
             R = <a_hi, G_lo> + <a_hi, b_lo> U
             u = challenge;  a' = u a_lo + u^-1 a_hi
             b' = u^-1 b_lo + u b_hi ;  G' = u^-1 G_lo + u G_hi
             P' = P + u^2 L + u^-2 R
    final:   check P_final == a G_final + (a * b_final) U

The verifier folds b and the coefficient vector s (for G_final =
<s, G>) in O(n); the two MSMs are device-offloadable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..curves.weierstrass import Affine, Curve
from ..hostlib import msm as host_msm
from ..hostlib.fastpack import pack_ints
from ..utils import tracing
from .transcript import Transcript

_HOST_MSM_FROM = 64


@dataclasses.dataclass
class IpaProof:
    ls: List[Affine]
    rs: List[Affine]
    a_final: int


def _u_generator(curve: Curve) -> Affine:
    from .params_cache import load_generators
    return load_generators(curve, b"lurk_tpu.ipa.U." + curve.name.encode(),
                           1)[0]


def _basis_msm(curve: Curve, gens: Sequence[Affine]):
    """Σ s_j gens[j] over the first n generators, as a function of the
    n scalars (canonical, below the group order). Spans: ``ipa.pack_gens``
    and each MSM's ``ipa.msm``."""
    n = len(gens)
    if n < _HOST_MSM_FROM:
        def run(scalars):
            return curve.pippenger(list(scalars), list(gens))
    else:
        with tracing.span("ipa.pack_gens", n=n):
            points = host_msm.pack_points(gens)

        def run(scalars):
            return host_msm.msm(curve, pack_ints(scalars), points)

    def msm(scalars):
        with tracing.span("ipa.msm", n=n):
            return run(scalars)
    return msm


def _fold_scalars(v: Sequence[int], u: int, u_inv: int, q: int,
                  lo_coeff_is_u: bool) -> List[int]:
    half = len(v) // 2
    cl, ch = (u, u_inv) if lo_coeff_is_u else (u_inv, u)
    return [(cl * v[i] + ch * v[i + half]) % q for i in range(half)]


def prove(curve: Curve, gens: Sequence[Affine], comm: Affine,
          a: Sequence[int], b: Sequence[int], c: int,
          tr: Transcript) -> IpaProof:
    """Open <a, b> = c against P = <a, gens>. len(a) must be a power of
    two (pad with zeros; Pedersen prefix property keeps P unchanged).

    The generator vector is NEVER materialized in folded form (that
    would cost n EC two-scalar muls): folding is linear, so each
    round's L = <a_lo, G_hi^(k)> is computed as one MSM over the
    ORIGINAL generators. After k rounds the basis gens[j] contributes
    to folded position j mod L_k with the challenge-tensor coefficient
    w_j = prod_t u_t^{±1} (sign by bit t of j) — the same tensor the
    verifier uses for G_final."""
    q = curve.order
    n = len(a)
    assert n and (n & (n - 1)) == 0 and len(b) == n and len(gens) >= n
    u_gen = _u_generator(curve)
    tr.absorb_point(comm)
    tr.absorb_scalar(c % q)
    x = tr.squeeze() % q
    big_u = curve.mul(x, u_gen)
    a = [v % q for v in a]
    b = [v % q for v in b]
    basis_msm = _basis_msm(curve, list(gens[:n]))

    w = [1] * n                       # gens[j] coefficient in folded G
    cur = n                           # current folded length L_k
    ls: List[Affine] = []
    rs: List[Affine] = []
    while cur > 1:
        half = cur // 2
        a_lo, a_hi = a[:half], a[half:]
        b_lo, b_hi = b[:half], b[half:]
        cl = sum(x * y for x, y in zip(a_lo, b_hi)) % q
        cr = sum(x * y for x, y in zip(a_hi, b_lo)) % q
        # L = <a_lo, G_hi>, R = <a_hi, G_lo> over the original basis
        scal_l = [0] * n
        scal_r = [0] * n
        for j in range(n):
            pos = j % cur
            if pos >= half:
                scal_l[j] = a_lo[pos - half] * w[j] % q
            else:
                scal_r[j] = a_hi[pos] * w[j] % q
        l_pt = curve.add(basis_msm(scal_l), curve.mul(cl, big_u))
        r_pt = curve.add(basis_msm(scal_r), curve.mul(cr, big_u))
        ls.append(l_pt)
        rs.append(r_pt)
        tr.absorb_point(l_pt)
        tr.absorb_point(r_pt)
        u = tr.squeeze() % q or 1
        u_inv = pow(u, -1, q)
        a = _fold_scalars(a, u, u_inv, q, lo_coeff_is_u=True)
        b = _fold_scalars(b, u, u_inv, q, lo_coeff_is_u=False)
        for j in range(n):
            w[j] = w[j] * (u if (j % cur) >= half else u_inv) % q
        cur = half
    return IpaProof(ls, rs, a[0])


def verify(curve: Curve, gens: Sequence[Affine], comm: Affine,
           b: Sequence[int], c: int, proof: IpaProof,
           tr: Transcript) -> bool:
    q = curve.order
    n = len(b)
    if n == 0 or (n & (n - 1)) != 0 or len(proof.ls) != n.bit_length() - 1:
        return False
    if len(proof.rs) != len(proof.ls) or len(gens) < n:
        return False
    u_gen = _u_generator(curve)
    tr.absorb_point(comm)
    tr.absorb_scalar(c % q)
    x = tr.squeeze() % q
    big_u = curve.mul(x, u_gen)
    p_acc = curve.add(comm, curve.mul(c % q, big_u))
    challenges = []
    for l_pt, r_pt in zip(proof.ls, proof.rs):
        tr.absorb_point(l_pt)
        tr.absorb_point(r_pt)
        u = tr.squeeze() % q or 1
        challenges.append(u)
        u_inv = pow(u, -1, q)
        p_acc = curve.add(
            p_acc,
            curve.add(curve.mul(u * u % q, l_pt),
                      curve.mul(u_inv * u_inv % q, r_pt)))
    # fold b, and build the G coefficient vector s: round 0 splits at
    # the TOP (MSB) of the index space, so s is tensored with the
    # challenges reversed — s[i] = prod_j u_j^(+1 if MSB-bit_j(i) else -1)
    b_cur = [v % q for v in b]
    for u in challenges:
        b_cur = _fold_scalars(b_cur, u, pow(u, -1, q), q,
                              lo_coeff_is_u=False)
    s = [1]
    for u in reversed(challenges):
        u_inv = pow(u, -1, q)
        s = [v * u_inv % q for v in s] + [v * u % q for v in s]
    g_final = _basis_msm(curve, list(gens[:n]))(s)
    b_final = b_cur[0]
    a_final = proof.a_final % q
    lhs = p_acc
    rhs = curve.add(curve.mul(a_final, g_final),
                    curve.mul(a_final * b_final % q, big_u))
    return lhs == rhs
