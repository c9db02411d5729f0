"""The compressed proof, judged on Python integers: each Spartan proof
of a final accumulator, its sumchecks replayed on this reference's own
transcript, its claims held against the witness, and its openings:
HyperKZG on BN254 value by value with the key's public trapdoor, the
IPA on Grumpkin as its verifier runs it, the one MSM of its last check
left to ``GrumpkinClaims``. The protocol is the port's published one
(``lurk_tpu_torch/proof/spartan.py``, ``hyperkzg.py``, ``ipa.py``), so
a proof that a sound change to the prover leaves bit for bit the same
passes, and one that drops a transcript entry on both sides does not.

Vectors are NumPy arrays of Python integers. ``chi(rs)[i]`` is
prod_j (r_j if bit j of i else 1 - r_j), bit 0 the most significant;
a vector's MLE at ``rs`` is its dot product with ``chi(rs)``.
"""

from __future__ import annotations

import hashlib
import random
from typing import List, Sequence, Tuple

import numpy as np

from .curve import BN254, GRUMPKIN, Affine, Curve
from .transcript import Transcript, absorb_relaxed

IPA_U_LABEL = b"lurk_tpu.ipa.U.grumpkin"
TAU_LABEL = b"lurk_tpu.hyperkzg.tau.v1"


def tau() -> int:
    """The trapdoor of the port's BN254 key, a development powers-of-tau
    SRS whose i-th generator is [tau^i] G: shake256 of a public label
    (``lurk_tpu_torch/proof/hyperkzg.py``), 48 bytes little-endian mod
    r. So a commitment to W is [W(tau)] G, one scalar product for any
    length."""
    return int.from_bytes(hashlib.shake_256(TAU_LABEL).digest(48),
                          "little") % BN254.order


def kzg_commit(vec: np.ndarray, tau_powers: np.ndarray) -> Affine:
    """[sum_i vec_i tau^i] G."""
    return BN254.mul(dot(vec, tau_powers, BN254.order))


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def pad(vec: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=object)
    out[:len(vec)] = vec
    return out


def chi(rs: Sequence[int], p: int) -> np.ndarray:
    t = obj([1])
    for r in reversed(rs):
        t = np.concatenate([t * ((1 - r) % p) % p, t * r % p])
    return t


def dot(a: np.ndarray, b: np.ndarray, p: int) -> int:
    n = min(len(a), len(b))
    return int((a[:n] * b[:n]).sum() % p) if n else 0


def powers(z: int, n: int, p: int) -> np.ndarray:
    """[z^0, .., z^(n-1)]."""
    block = 1 << max(1, (max(n, 2).bit_length() + 1) // 2)
    lo = [1]
    for _ in range(block - 1):
        lo.append(lo[-1] * z % p)
    zb = lo[-1] * z % p
    hi = [1]
    for _ in range(-(-n // block) - 1):
        hi.append(hi[-1] * zb % p)
    return (np.outer(obj(hi), obj(lo)) % p).ravel()[:n]


def lagrange(evals: Sequence[int], t: int, p: int) -> int:
    acc, n = 0, len(evals)
    for j in range(n):
        num = den = 1
        for m in range(n):
            if m != j:
                num, den = num * (t - m) % p, den * (j - m) % p
        acc = (acc + evals[j] * num * pow(den, -1, p)) % p
    return acc


def sumcheck(claim: int, polys, degree: int, p: int,
             tr: Transcript) -> Tuple[int, List[int], int]:
    """(final claim, challenges, rounds that break the sum)."""
    e, rs, bad = claim % p, [], 0
    for evals in polys:
        if len(evals) != degree + 1:
            return e, rs, bad + 1
        bad += (evals[0] + evals[1]) % p != e
        for v in evals:
            tr.absorb_scalar(v)
        r = tr.squeeze() % p
        rs.append(r)
        e = lagrange(evals, r, p)
    return e, rs, bad


def matrix_eval(mat, chi_rx: np.ndarray, chi_ry: np.ndarray,
                num_inputs: int, n_half: int, p: int) -> int:
    """M~(rx, ry) over the split-z domain: z's column j < num_inputs sits
    at j, the witness's column j at n_half + j - num_inputs."""
    indptr, cols, coefs = mat
    counts = np.diff(indptr)
    if counts.sum() == 0:
        return 0
    rows = np.repeat(np.arange(len(counts)), counts)
    cols = np.asarray(cols, dtype=np.int64)
    at = np.where(cols < num_inputs, cols, n_half + cols - num_inputs)
    return int(((coefs * chi_rx[rows]) % p * chi_ry[at]).sum() % p)


def fold_chain(poly: np.ndarray, point: Sequence[int],
               p: int) -> List[np.ndarray]:
    """Gemini's chain: v_0 the poly, v_(i+1)[j] = v_i[2j] + x_i (v_i[2j+1]
    - v_i[2j]), x the point reversed, for i < k - 1."""
    xs = [v % p for v in reversed(point)]
    chain = [poly]
    for x in xs[:len(point) - 1]:
        v = chain[-1]
        chain.append((v[0::2] + x * (v[1::2] - v[0::2])) % p)
    return chain


def interp3(zs, fs, p: int) -> List[int]:
    c = [0, 0, 0]
    for i in range(3):
        a, b = [zs[j] for j in range(3) if j != i]
        den = (zs[i] - a) * (zs[i] - b) % p
        scale = fs[i] * pow(den, -1, p) % p
        c[0] = (c[0] + scale * a * b) % p
        c[1] = (c[1] - scale * (a + b)) % p
        c[2] = (c[2] + scale) % p
    return c


def hyperkzg_off(tr: Transcript, claims, proof: dict, tau: int,
                 pows: dict) -> int:
    """Entries of a HyperKZG batch opening that differ from the honest
    prover's: each chain commitment [v_i(tau)] G, each evaluation
    v_i(z) at z in (r, -r, r^2), the quotient [h(tau)] G with h = (F -
    r_F) / Z, and the point [L(tau) / (tau - u)] G with L = F - r_F(u) -
    Z(u) h; F = sum_c gamma^c v_c. ``claims``: (poly, point) per
    opening."""
    q = BN254.order
    comms, evals = proof["comms"], proof["evals"]
    if len(comms) != len(claims) or len(evals) != len(claims):
        return 1
    chains = [fold_chain(poly, point, q) for poly, point in claims]
    for ch, cms, evs in zip(chains, comms, evals):
        if len(cms) != len(ch) - 1 or len(evs) != len(ch):
            return 1
    for cms in comms:
        for cm in cms:
            tr.absorb_point(cm)
    r = tr.squeeze() % q or 1
    zs = (r, (-r) % q, r * r % q)
    for evs in evals:
        for ev in evs:
            for v in ev:
                tr.absorb_scalar(v)
    gamma = tr.squeeze() % q

    def at(v, z):
        if z not in pows or len(pows[z]) < len(v):
            pows[z] = powers(z, max(len(v), len(pows.get(z, ()))), q)
        return dot(v, pows[z], q)

    off, g, f_tau, f_ev = 0, 1, 0, [0, 0, 0]
    for ch, cms, evs in zip(chains, comms, evals):
        for i, v in enumerate(ch):
            vt = at(v, tau)
            if i:
                off += cms[i - 1] != BN254.mul(vt)
            ev = [at(v, z) for z in zs]
            off += tuple(evs[i]) != tuple(ev)
            f_tau = (f_tau + g * vt) % q
            f_ev = [(f + g * e) % q for f, e in zip(f_ev, ev)]
            g = g * gamma % q
    rf = interp3(zs, f_ev, q)

    def rf_at(x):
        return (rf[0] + rf[1] * x + rf[2] * x * x) % q

    def z_at(x):
        return (x - zs[0]) * (x - zs[1]) * (x - zs[2]) % q

    h_tau = (f_tau - rf_at(tau)) * pow(z_at(tau), -1, q) % q
    off += proof["w"] != BN254.mul(h_tau)
    tr.absorb_point(proof["w"])
    u = tr.squeeze() % q
    l_tau = (f_tau - rf_at(u) - z_at(u) * h_tau) % q
    off += proof["wp"] != BN254.mul(l_tau * pow(tau - u, -1, q))
    tr.absorb_point(proof["wp"])
    tr.squeeze()
    return off


class GrumpkinClaims:
    """Claims lhs == <scalars, G> on the Grumpkin key G, checked with
    one MSM as a random combination, and one by one only where that
    fails (to count them). Each claim carries the number it counts
    in."""

    def __init__(self):
        self.claims: List[Tuple[str, Affine, np.ndarray]] = []

    def add(self, number: str, lhs: Affine, scalars: np.ndarray) -> None:
        self.claims.append((number, lhs, scalars))

    def off(self, gens: Sequence[Affine]) -> dict:
        out = {}
        if not self.claims:
            return out
        q = GRUMPKIN.order
        rng = random.Random(repr([c[1] for c in self.claims]))
        rhos = [rng.getrandbits(128) | 1 for _ in self.claims]
        n = max(len(s) for _, _, s in self.claims)
        if n > len(gens):
            for number, _, _ in self.claims:
                out[number] = out.get(number, 0) + 1
            return out
        total = np.zeros(n, dtype=object)
        for rho, (_, _, s) in zip(rhos, self.claims):
            total[:len(s)] = (total[:len(s)] + rho * s) % q
        lhs = GRUMPKIN.lincomb([(rho, c[1])
                                for rho, c in zip(rhos, self.claims)])
        if lhs == GRUMPKIN.msm(list(total), gens[:n]):
            return out
        for number, point, s in self.claims:
            bad = point != GRUMPKIN.msm(list(s), gens[:len(s)])
            out[number] = out.get(number, 0) + int(bad)
        return out


def ipa(tr: Transcript, comm: Affine, b: np.ndarray, c: int, proof: dict,
        u_gen: Affine, claims: GrumpkinClaims) -> int:
    """The IPA verifier on Grumpkin: P = comm + c U, each round's
    P += u^2 L + u^-2 R, and at the end P == a G_final + a b_final U with
    G_final = <s, G>, which goes to ``claims``; U = x u_gen."""
    q = GRUMPKIN.order
    n = len(b)
    ls, rs = proof["ls"], proof["rs"]
    if n & (n - 1) or len(ls) != n.bit_length() - 1 or len(rs) != len(ls):
        return 1
    tr.absorb_point(comm)
    tr.absorb_scalar(c % q)
    big_u = GRUMPKIN.mul(tr.squeeze() % q, u_gen)
    terms = [(1, comm), (c, big_u)]
    us = []
    for l_pt, r_pt in zip(ls, rs):
        tr.absorb_point(l_pt)
        tr.absorb_point(r_pt)
        u = tr.squeeze() % q or 1
        us.append(u)
        u_inv = pow(u, -1, q)
        terms += [(u * u, l_pt), (u_inv * u_inv, r_pt)]
    bf = b % q
    for u in us:
        half = len(bf) // 2
        bf = (pow(u, -1, q) * bf[:half] + u * bf[half:]) % q
    s = obj([1])
    for u in reversed(us):
        s = np.concatenate([s * pow(u, -1, q) % q, s * u % q])
    a = proof["a_final"] % q
    terms.append(((-a * int(bf[0])) % q, big_u))
    claims.add("compressed_off", GRUMPKIN.lincomb(terms), s * a % q)
    return 0


def spartan_off(curve: Curve, shape: dict, inst, w: np.ndarray,
                e: np.ndarray, prods, proof: dict, tau: int, pows: dict,
                claims: GrumpkinClaims, u_gen: Affine = None) -> int:
    """Disagreements in one Spartan proof of the relaxed instance
    ``inst`` = (comm_w, comm_e, x, u) with witness (w, e); ``prods`` the
    witness's (Az, Bz, Cz)."""
    p = shape["p"]
    m, num_inputs = shape["num_constraints"], shape["num_inputs"]
    n_half = next_pow2(max(shape["num_aux"], num_inputs))
    m_pad = next_pow2(max(m, 2))
    s_x, s_y = m_pad.bit_length() - 1, (2 * n_half).bit_length() - 1
    sc1, sc2 = proof["sc1"], proof["sc2"]
    if len(sc1) != s_x or len(sc2) != s_y:
        return 1
    _, _, x, u = inst
    u %= p
    tr = Transcript(curve, b"lurk_tpu.spartan")
    tr.absorb(int(shape["digest"][:32], 16))
    absorb_relaxed(tr, inst)
    taus = [tr.squeeze() % p for _ in range(s_x)]
    e1, rx, off = sumcheck(0, sc1, 3, p, tr)
    az_r, bz_r, cz_r, e_r = (v % p for v in proof["claims"])
    eq = 1
    for t, r in zip(taus, rx):
        eq = eq * (t * r + (1 - t) * (1 - r)) % p
    off += e1 != eq * (az_r * bz_r - u * cz_r - e_r) % p
    chi_rx = chi(rx, p)
    az, bz, cz = prods
    off += sum(got != dot(chi_rx, vec, p) for got, vec in
               ((az_r, az), (bz_r, bz), (cz_r, cz), (e_r, e)))
    for v in (az_r, bz_r, cz_r, e_r):
        tr.absorb_scalar(v)
    r = tr.squeeze() % p
    claim2 = (az_r + r * bz_r + r * r * cz_r) % p
    e2, ry, bad = sumcheck(claim2, sc2, 2, p, tr)
    off += bad
    chi_ry1 = chi(ry[1:], p)
    chi_ry = np.concatenate([chi_ry1 * ((1 - ry[0]) % p) % p,
                             chi_ry1 * ry[0] % p])
    a_ev, b_ev, c_ev = (matrix_eval(mat, chi_rx, chi_ry, num_inputs, n_half,
                                    p) for mat in shape["mats"])
    w_eval = proof["w_eval"] % p
    pub = dot(obj([u] + [v % p for v in x]), chi_ry1, p)
    z_eval = ((1 - ry[0]) * pub + ry[0] * w_eval) % p
    off += e2 != (a_ev + r * b_ev + r * r * c_ev) * z_eval % p
    off += w_eval != dot(chi_ry1, w, p)
    tr.absorb_scalar(w_eval)
    if curve is BN254:
        return off + hyperkzg_off(
            tr, [(pad(w, n_half), ry[1:]), (pad(e, m_pad), rx)],
            proof["hkzg"], tau, pows)
    off += ipa(tr, inst[0], chi_ry1, w_eval, proof["ipa_w"], u_gen, claims)
    off += ipa(tr, inst[1], chi_rx, e_r, proof["ipa_e"], u_gen, claims)
    return off
