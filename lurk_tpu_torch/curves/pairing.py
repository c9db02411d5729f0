"""BN254 optimal-ate pairing (host-side, verification-only).

A copy of the JAX package's ``lurk_tpu/curves/pairing.py`` (pure
Python). This slice uses ``G2_GEN`` and ``g2_mul`` for ``Srs.tau_g2``.

Provides what the HyperKZG polynomial-commitment engine needs: G2
arithmetic over Fp2 and the pairing e: G1 x G2 -> Fp12. The reference
reaches this functionality through halo2curves' `Bn256` pairing engine
(reference Cargo.toml:68; src/proof/nova.rs:56-71 wires
`Bn256EngineKZG` whose evaluation engine verifies KZG openings with
pairings). Pairings run a handful of times per proof verification —
host Python is the right place for them; the MSM-heavy proving side
stays on the native/device paths.

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (9+u)),
Fp12 = Fp6[w]/(w^2 - v). D-type twist E': y^2 = x^3 + 3/(9+u).

Self-checks: bilinearity e(aP, bQ) = e(P, Q)^(ab) pinned in
the JAX package's tests/test_hyperkzg.py (test_pairing_bilinearity).
"""

from __future__ import annotations

from typing import Optional, Tuple

# BN254 parameters
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_U = 4965661367192848881          # BN curve parameter t
ATE_LOOP = 6 * BN_U + 2

Fp2 = Tuple[int, int]               # a + b*u

G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % Q, -a[1] % Q)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    t0 = a[0] * b[0] % Q
    t1 = a[1] * b[1] % Q
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % Q
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def f2_scal(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % Q, a[1] * k % Q)


def f2_sq(a: Fp2) -> Fp2:
    t0 = (a[0] + a[1]) * (a[0] - a[1]) % Q
    t1 = 2 * a[0] * a[1] % Q
    return (t0, t1)


def f2_inv(a: Fp2) -> Fp2:
    d = (a[0] * a[0] + a[1] * a[1]) % Q
    di = pow(d, Q - 2, Q)
    return (a[0] * di % Q, -a[1] * di % Q)


def f2_conj(a: Fp2) -> Fp2:
    return (a[0], -a[1] % Q)


XI: Fp2 = (9, 1)                    # the sextic non-residue 9 + u


def f2_mul_xi(a: Fp2) -> Fp2:
    return f2_mul(a, XI)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi): (c0, c1, c2)
# ---------------------------------------------------------------------------

Fp6 = Tuple[Fp2, Fp2, Fp2]
F6_ZERO: Fp6 = ((0, 0), (0, 0), (0, 0))
F6_ONE: Fp6 = ((1, 0), (0, 0), (0, 0))


def f6_add(a: Fp6, b: Fp6) -> Fp6:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fp6, b: Fp6) -> Fp6:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fp6) -> Fp6:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fp6, b: Fp6) -> Fp6:
    t0 = f2_mul(a[0], b[0])
    t1 = f2_mul(a[1], b[1])
    t2 = f2_mul(a[2], b[2])
    c0 = f2_add(t0, f2_mul_xi(
        f2_sub(f2_mul(f2_add(a[1], a[2]), f2_add(b[1], b[2])),
               f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a[0], a[1]), f2_add(b[0], b[1])),
                       f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a[0], a[2]), f2_add(b[0], b[2])),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(a: Fp6) -> Fp6:
    return f6_mul(a, a)


def f6_mul_v(a: Fp6) -> Fp6:
    """Multiply by v."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a: Fp6) -> Fp6:
    c0 = f2_sub(f2_sq(a[0]), f2_mul_xi(f2_mul(a[1], a[2])))
    c1 = f2_sub(f2_mul_xi(f2_sq(a[2])), f2_mul(a[0], a[1]))
    c2 = f2_sub(f2_sq(a[1]), f2_mul(a[0], a[2]))
    t = f2_add(f2_mul(a[0], c0),
               f2_mul_xi(f2_add(f2_mul(a[2], c1), f2_mul(a[1], c2))))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v): (c0, c1)
# ---------------------------------------------------------------------------

Fp12 = Tuple[Fp6, Fp6]
F12_ONE: Fp12 = (F6_ONE, F6_ZERO)


def f12_mul(a: Fp12, b: Fp12) -> Fp12:
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])),
                f6_add(t0, t1))
    return (c0, c1)


def f12_sq(a: Fp12) -> Fp12:
    return f12_mul(a, a)


def f12_inv(a: Fp12) -> Fp12:
    t = f6_inv(f6_sub(f6_sq(a[0]), f6_mul_v(f6_sq(a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_conj(a: Fp12) -> Fp12:
    return (a[0], f6_neg(a[1]))


def f12_pow(a: Fp12, e: int) -> Fp12:
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sq(base)
        e >>= 1
    return out


# Frobenius coefficients: gamma_{1,j} = xi^((q-1)*j/6) for j=1..5
def _frob_coeffs():
    out = []
    e = (Q - 1) // 6
    # xi^e in Fp2 via square-and-multiply
    def f2_pow(a, k):
        r = (1, 0)
        while k:
            if k & 1:
                r = f2_mul(r, a)
            a = f2_sq(a)
            k >>= 1
        return r
    base = f2_pow(XI, e)
    acc = (1, 0)
    for _ in range(5):
        acc = f2_mul(acc, base)
        out.append(acc)
    return out


_G1J = _frob_coeffs()


def f12_frobenius(a: Fp12) -> Fp12:
    """a -> a^q."""
    c00, c01, c02 = (f2_conj(x) for x in a[0])
    c10, c11, c12 = (f2_conj(x) for x in a[1])
    return (
        (c00, f2_mul(c01, _G1J[1]), f2_mul(c02, _G1J[3])),
        (f2_mul(c10, _G1J[0]), f2_mul(c11, _G1J[2]),
         f2_mul(c12, _G1J[4])),
    )


# ---------------------------------------------------------------------------
# G2 (projective over Fp2, twist y^2 = x^3 + 3/xi)
# ---------------------------------------------------------------------------

B2: Fp2 = f2_mul((3, 0), f2_inv(XI))
G2Point = Optional[Tuple[Fp2, Fp2]]          # affine; None = infinity


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sq(y) == f2_add(f2_mul(f2_sq(x), x), B2)


def g2_add(a: G2Point, b: G2Point) -> G2Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == (0, 0):
            return None
        lam = f2_mul(f2_scal(f2_sq(x1), 3),
                     f2_inv(f2_scal(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(a: G2Point) -> G2Point:
    return None if a is None else (a[0], f2_neg(a[1]))


def g2_mul(k: int, pt: G2Point) -> G2Point:
    k %= R
    out: G2Point = None
    add = pt
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def _g2_frobenius(pt: G2Point) -> G2Point:
    """The untwist-Frobenius-twist endomorphism psi."""
    if pt is None:
        return None
    x, y = pt
    # psi(x, y) = (conj(x) * gamma_{1,2}', conj(y) * gamma_{1,3}')
    # with gamma' = xi^((q-1)/3), xi^((q-1)/2) in Fp2
    def f2_pow(a, k):
        r = (1, 0)
        while k:
            if k & 1:
                r = f2_mul(r, a)
            a = f2_sq(a)
            k >>= 1
        return r
    cx = f2_pow(XI, (Q - 1) // 3)
    cy = f2_pow(XI, (Q - 1) // 2)
    return (f2_mul(f2_conj(x), cx), f2_mul(f2_conj(y), cy))


# ---------------------------------------------------------------------------
# Miller loop (generic over E(Fp12) via the untwist embedding) + final
# exponentiation. Correctness-transparent formulation: G2 points map to
# E: y^2 = x^3 + 3 over Fp12 as (x'*w^2, y'*w^3) (w^2 = v, v^3 = xi, so
# the twist constant cancels), Frobenius corrections are literal
# coordinate-wise q-power maps, and lines are evaluated with full Fp12
# arithmetic. ~ms per pairing — verification-only.
# ---------------------------------------------------------------------------


def f12_sub(a: Fp12, b: Fp12) -> Fp12:
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def _fp12_from_fp(x: int) -> Fp12:
    return (((x % Q, 0), (0, 0), (0, 0)), F6_ZERO)


def _embed_g2(q: Tuple[Fp2, Fp2]) -> Tuple[Fp12, Fp12]:
    """(x', y') on the twist -> (x'*w^2, y'*w^3) on E(Fp12)."""
    x2, y2 = q
    x12: Fp12 = ((((0, 0)), x2, (0, 0)), F6_ZERO)     # x' * v
    y12: Fp12 = (F6_ZERO, ((0, 0), y2, (0, 0)))       # y' * v * w
    return x12, y12


def _pt_frob(pt: Tuple[Fp12, Fp12]) -> Tuple[Fp12, Fp12]:
    return (f12_frobenius(pt[0]), f12_frobenius(pt[1]))


def _pt_neg12(pt: Tuple[Fp12, Fp12]) -> Tuple[Fp12, Fp12]:
    return (pt[0], (f6_neg(pt[1][0]), f6_neg(pt[1][1])))


def _miller_step(f: Fp12, t, q_or_none, p12) -> Tuple[Fp12, Tuple]:
    """One add-or-double step: line through (T, Q) (or tangent at T if
    q_or_none is None) evaluated at P; returns (f * line, T+Q or 2T)."""
    xt, yt = t
    xp, yp = p12
    if q_or_none is None:
        num = f12_mul(_fp12_from_fp(3), f12_sq(xt))
        den = f12_mul(_fp12_from_fp(2), yt)
    else:
        xq, yq = q_or_none
        num = f12_sub(yq, yt)
        den = f12_sub(xq, xt)
    lam = f12_mul(num, f12_inv(den))
    line = f12_sub(f12_mul(lam, f12_sub(xp, xt)), f12_sub(yp, yt))
    x3 = f12_sub(f12_sub(f12_sq(lam), xt),
                 xt if q_or_none is None else q_or_none[0])
    y3 = f12_sub(f12_mul(lam, f12_sub(xt, x3)), yt)
    return f12_mul(f, line), (x3, y3)


def miller_loop(p: Optional[Tuple[int, int]], q: G2Point) -> Fp12:
    if p is None or q is None:
        return F12_ONE
    p12 = (_fp12_from_fp(p[0]), _fp12_from_fp(p[1]))
    q12 = _embed_g2(q)
    t = q12
    f = F12_ONE
    for b in bin(ATE_LOOP)[3:]:
        f = f12_sq(f)
        f, t = _miller_step(f, t, None, p12)
        if b == "1":
            f, t = _miller_step(f, t, q12, p12)
    # optimal-ate Frobenius corrections: add psi(Q), then -psi^2(Q)
    q1 = _pt_frob(q12)
    q2 = _pt_neg12(_pt_frob(_pt_frob(q12)))
    f, t = _miller_step(f, t, q1, p12)
    f, _ = _miller_step(f, t, q2, p12)
    return f


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((q^12 - 1)/r): easy part then (q^4 - q^2 + 1)/r hard part
    (generic exponentiation — a few extra ms, verification-only)."""
    # easy: f^(q^6 - 1) * ... = (conj(f) * f^-1)^(q^2 + 1)
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f2 = f12_mul(f12_frobenius(f12_frobenius(f1)), f1)
    # hard: exponent (q^4 - q^2 + 1) // r
    e = (Q ** 4 - Q ** 2 + 1) // R
    return f12_pow(f2, e)


def pairing(p: Optional[Tuple[int, int]], q: G2Point) -> Fp12:
    """e(P, Q) for P on BN254 G1 (affine host ints), Q on G2."""
    return final_exponentiation(miller_loop(p, q))


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 via one shared final exponentiation."""
    f = F12_ONE
    for p, q in pairs:
        f = f12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == F12_ONE
