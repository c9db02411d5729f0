"""HyperKZG multilinear polynomial-commitment engine over BN254.

The port of the JAX package's ``proof/hyperkzg.py``: the powers-of-tau
SRS (``load_srs``; the BN254 G1 commitment key is the SRS,
``proof/nova.py``), the joint opening protocol (``prove_batch``,
``verify_batch``), the one Spartan uses, and the verifier of a single
opening (``verify``), which older proofs carry for W and E each. The
reference's default BN256
engine is `Bn256EngineKZG`, whose evaluation engine is HyperKZG
(reference src/proof/nova.rs:56-71; arecibo provider::hyperkzg): a
multilinear evaluation claim is reduced to univariate KZG openings
through the Gemini even/odd folding trick, verified with pairings
(:mod:`..curves.pairing`).

Routes, one each: the provers' commits over the SRS powers (the fold
chain, the quotients) go to a :class:`.nova.CommitmentKey` whose
generators are those powers, so K6 on a CUDA key and the host
Pippenger on a CPU key; the fold chain's folds, evaluations, batching
and quotients run on packed vectors in the host C++
(:mod:`..hostlib.spartan`, :mod:`..hostlib.r1cs`). The JAX package's
Python loops are their plain versions, held in
``tests/test_torch_compress.py``.

Protocol (prove W~(x) = v for W committed as C = <W, [tau^i]_1>):
  1. Fold LSB-first: v_0 = W; v_{i+1}[j] = (1-x_i) v_i[2j] + x_i
     v_i[2j+1]. Commit v_1..v_{k-1}.
  2. Challenge r. Open every v_i at {r, -r, r^2}; the even/odd split
     makes the fold checkable from the evaluations.
  3. Batch the openings of several claims into one two-pairing check:
     the joint Shplonk argument, two quotient commits in all.

SRS: tau is derived from shake256 and used transiently to compute
[tau^i]_1 / [tau]_2, then discarded — a DEV SRS, functionally faithful
but not a trusted-setup ceremony. The powers come from the host C++
(``csrc/host/srs.cpp``); three points of every new batch are checked
against the Python fixed-base oracle, and a mismatch raises. Cached on
disk in the params-cache layout (``proof/params_cache.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Sequence, Tuple

import numpy as np

from ..curves import pairing as pr
from ..curves.weierstrass import BN254_G1, Affine
from ..hostlib import points_from_limbs
from ..hostlib import r1cs as hr
from ..hostlib import spartan as hsc
from ..hostlib.r1cs import PackedVec
from .transcript import Transcript

CURVE = BN254_G1
_TAU_LABEL = b"lurk_tpu.hyperkzg.tau.v1"


def _tau() -> int:
    """The dev-SRS toxic waste (see module docstring)."""
    d = hashlib.shake_256(_TAU_LABEL).digest(48)
    return int.from_bytes(d, "little") % CURVE.order


@dataclasses.dataclass
class Srs:
    powers: List[Affine]            # [tau^i]_1, i < n
    g2: pr.G2Point                  # [1]_2
    tau_g2: pr.G2Point              # [tau]_2


def _fixed_base_mul_table(gen: Affine, c: int = 8):
    """Window table for fast fixed-base scalar muls."""
    curve = CURVE
    n_win = (curve.scalar.num_bits + c - 1) // c
    table = []
    base = curve.jac_from_affine(gen)
    for _ in range(n_win):
        row = [(0, 1, 0)]
        acc = (0, 1, 0)
        for _ in range((1 << c) - 1):
            acc = curve.jac_add(acc, base)
            row.append(acc)
        table.append(row)
        for _ in range(c):
            base = curve.jac_double(base)
    return table, c


def _fixed_base_mul(table, c: int, k: int) -> Affine:
    curve = CURVE
    acc = (0, 1, 0)
    w = 0
    mask = (1 << c) - 1
    while k:
        d = k & mask
        if d:
            acc = curve.jac_add(acc, table[w][d])
        k >>= c
        w += 1
    return curve.jac_to_affine(acc)


_SRS_MEM: dict = {}


def load_srs(n: int) -> Srs:
    """Powers-of-tau SRS, grown and cached on disk (and in memory)."""
    for have, srs in _SRS_MEM.items():
        if have >= n:
            return srs
    srs = _load_srs_disk(n)
    _SRS_MEM.clear()
    _SRS_MEM[len(srs.powers)] = srs
    return srs


def _load_srs_disk(n: int) -> Srs:
    import fcntl
    from .params_cache import _atomic_write, cache_dir
    from ..hostlib.srs import srs_limbs
    key = "hyperkzg_srs_bn254"
    path = cache_dir() / f"{key}.bin"
    meta_path = cache_dir() / f"{key}.json"
    lock_path = cache_dir() / f"{key}.lock"
    tau = _tau()
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        limbs = np.zeros((0, 8), dtype="<u8")
        if path.exists() and meta_path.exists():
            have = min(json.loads(meta_path.read_text())["n"], n)
            limbs = np.frombuffer(path.read_bytes(), dtype="<u8",
                                  count=8 * have).reshape(have, 8)
        if len(limbs) < n:
            start = len(limbs)
            got = srs_limbs(CURVE, tau, start, n - start)
            # spot-check the host C++ batch against the Python
            # fixed-base oracle before trusting it
            table, c = _fixed_base_mul_table(CURVE.generator)
            for probe in sorted({0, len(got) // 2, len(got) - 1}):
                expect = _fixed_base_mul(
                    table, c, pow(tau, start + probe, CURVE.order))
                if points_from_limbs(got[probe:probe + 1])[0] != expect:
                    raise RuntimeError(
                        f"host SRS power {start + probe} differs from "
                        f"the Python fixed-base oracle")
            limbs = np.concatenate([limbs, got])
            _atomic_write(path, limbs.astype("<u8").tobytes())
            _atomic_write(meta_path, json.dumps({"n": n}).encode())
    return Srs(points_from_limbs(limbs), pr.G2_GEN,
               pr.g2_mul(tau, pr.G2_GEN))


# ---------------------------------------------------------------------------
# univariate KZG helpers
# ---------------------------------------------------------------------------


def _check_key(ck) -> None:
    if ck.curve.name != CURVE.name:
        raise ValueError(f"HyperKZG commits on {CURVE.name}, not on "
                         f"{ck.curve.name}")


def _commit_all(ck, vecs: Sequence[PackedVec]) -> List[Affine]:
    """Commit every vector over the SRS powers: all dispatched before
    any is waited for."""
    pending = [ck.commit_async(v) for v in vecs]
    return [res() for res in pending]


def _fold_chain(poly, point: Sequence[int], q: int) -> List[PackedVec]:
    """v_0 = poly, v_{i+1} the even/odd fold of v_i at x_i (LSB first),
    i < k - 1, as packed vectors."""
    n = len(poly)
    k = n.bit_length() - 1
    if n != 1 << k or len(point) != k:
        raise ValueError(f"a vector of {n} opened at {len(point)} "
                         f"variables")
    xs = [v % q for v in reversed(point)]
    pvs = [PackedVec.pack(poly, q)]
    for i in range(k - 1):
        prev = pvs[-1]
        pvs.append(hsc.bind_eo(PackedVec(prev.arr.copy(), prev.n, q),
                               xs[i]))
    return pvs


def _sub_prefix(arr: np.ndarray, vals: Sequence[int], r: int,
                q: int) -> None:
    """arr[:len(vals)] += r * vals, in place (packed)."""
    m = len(vals)
    pref = PackedVec(arr[:4 * m], m, q)
    arr[:4 * m] = hr.vec_rlc_pv(q, pref, PackedVec.pack(vals, q), r).arr


# ---------------------------------------------------------------------------
# A single opening (verify only: older proofs open W and E apart)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HkzgProof:
    """One claim's Gemini fold chain (v_1..v_{k-1} committed), each
    chain poly's evaluations at (r, -r, r^2), and one quotient commit a
    point of the batched univariate KZG opening."""

    comms: List[Affine]
    evals: List[Tuple[int, int, int]]
    quotients: List[Affine]


def verify(srs: Srs, comm: Affine, point: Sequence[int], value: int,
           proof: HkzgProof, tr: Transcript) -> bool:
    """Check W~(point) = value for ``comm`` from a single opening: the
    fold chain's consistency at r^2, then one two-pairing check over the
    three points batched by delta (the JAX package's ``verify``)."""
    q = CURVE.order
    k = len(point)
    if len(proof.comms) != k - 1 or len(proof.evals) != k or \
            len(proof.quotients) != 3:
        return False
    xs = [v % q for v in reversed(point)]
    for cm in proof.comms:
        tr.absorb_point(cm)
    r = tr.squeeze() % q or 1
    zs = (r, (-r) % q, r * r % q)
    for ev in proof.evals:
        if len(ev) != 3:
            return False
        for v in ev:
            tr.absorb_scalar(v)
    gamma = tr.squeeze() % q
    for w in proof.quotients:
        tr.absorb_point(w)
    inv2 = pow(2, q - 2, q)
    inv2r = pow(2 * r % q, q - 2, q)
    for i in range(k):
        er, enr, _ = proof.evals[i]
        nxt = ((1 - xs[i]) * (er + enr) % q * inv2 +
               xs[i] * (er - enr) % q * inv2r) % q
        want = proof.evals[i + 1][2] if i + 1 < k else value % q
        if nxt != want:
            return False
    delta = tr.squeeze() % q
    all_comms = [comm] + list(proof.comms)
    agg_c: Affine = None
    agg_w: Affine = None
    d = 1
    for j, z in enumerate(zs):
        # d_j (C_B - [B(z)]_1 + z W_j), C_B = sum_i gamma^i C_i
        g = 1
        cb: Affine = None
        bz = 0
        for i, cm in enumerate(all_comms):
            cb = CURVE.add(cb, CURVE.mul(g, cm))
            bz = (bz + g * proof.evals[i][j]) % q
            g = g * gamma % q
        wj = proof.quotients[j]
        term = CURVE.add(cb, CURVE.neg(CURVE.mul(bz, CURVE.generator)))
        term = CURVE.add(term, CURVE.mul(z, wj))
        agg_c = CURVE.add(agg_c, CURVE.mul(d, term))
        agg_w = CURVE.add(agg_w, CURVE.mul(d, wj))
        d = d * delta % q
    return pr.pairing_product_is_one([
        (agg_c, srs.g2),
        (CURVE.neg(agg_w) if agg_w else None, srs.tau_g2),
    ])


# ---------------------------------------------------------------------------
# Joint Shplonk (BDFG20) batch opening
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HkzgBatchProof:
    """Joint opening of several MLEs: per-claim Gemini fold chains
    share ONE evaluation point set S = {r, -r, r^2}; all chain polys
    batch (gamma powers) into one f whose combined quotient
    h = (f - r_f)/Z_S commits as W, opened at a fresh challenge u via
    W' (BDFG20 with only [tau]_2 in the SRS). Two size-n commits
    replace the 3-per-claim quotients."""

    comms: List[List[Affine]]
    evals: List[List[Tuple[int, int, int]]]
    w: Affine
    wp: Affine


def _interp3(zs, fs, q):
    """Degree-<=2 Lagrange interpolation -> coefficients [c0,c1,c2]."""
    c = [0, 0, 0]
    for i in range(3):
        zi = zs[i]
        others = [zs[j] for j in range(3) if j != i]
        denom = 1
        for zo in others:
            denom = denom * (zi - zo) % q
        scale = fs[i] * pow(denom, q - 2, q) % q
        # (X - a)(X - b) = X^2 - (a+b)X + ab
        a, b = others
        c[0] = (c[0] + scale * (a * b % q)) % q
        c[1] = (c[1] - scale * ((a + b) % q)) % q
        c[2] = (c[2] + scale) % q
    return c


def _zs_coeffs(zs, q):
    z0, z1, z2 = zs
    s1 = (z0 + z1 + z2) % q
    s2 = (z0 * z1 + z0 * z2 + z1 * z2) % q
    s3 = z0 * z1 * z2 % q
    return [(-s3) % q, s2, (-s1) % q, 1]     # X^3 - s1 X^2 + s2 X - s3


def prove_batch(ck, opens, tr: Transcript) -> HkzgBatchProof:
    """opens: list of (poly, point): poly a 2^k evaluation vector (ints
    or a PackedVec), point of length k (``mle_eval`` convention).
    Commits on ``ck`` (a BN254 key over the SRS powers)."""
    _check_key(ck)
    q = CURVE.order
    chains = []
    comms: List[List[Affine]] = []
    for poly, point in opens:
        ch = _fold_chain(poly, point, q)
        cms = _commit_all(ck, ch[1:])
        for cm in cms:
            tr.absorb_point(cm)
        chains.append(ch)
        comms.append(cms)
    r = tr.squeeze() % q or 1
    zs = (r, (-r) % q, r * r % q)
    evals = []
    for ch in chains:
        evs = [tuple(hsc.poly_eval(pv, z) for z in zs) for pv in ch]
        for ev in evs:
            for v in ev:
                tr.absorb_scalar(v)
        evals.append(evs)
    gamma = tr.squeeze() % q

    n_max = max(len(ch[0]) for ch in chains)
    # batched f = sum over all chain polys of gamma^c * poly; batched
    # evals at each z accumulate the same weights
    f_evals = [0, 0, 0]
    g = 1
    barr = np.zeros(4 * n_max, dtype=np.uint64)
    for ci, ch in enumerate(chains):
        for pi, pv in enumerate(ch):
            pref = PackedVec(barr[:4 * pv.n], pv.n, q)
            barr[:4 * pv.n] = hr.vec_rlc_pv(q, pref, pv, g).arr
            for j in range(3):
                f_evals[j] = (f_evals[j] + g * evals[ci][pi][j]) % q
            g = g * gamma % q
    batched = PackedVec(barr, n_max, q)

    rf = _interp3(zs, f_evals, q)
    # h = (f - r_f) / (X-z0)(X-z1)(X-z2): subtract then divide thrice
    garr = batched.arr.copy()
    _sub_prefix(garr, rf, q - 1, q)
    h = PackedVec(garr, n_max, q)
    for z in zs:
        h = hsc.poly_quotient(h, z)
    w_cm = ck.commit(h)
    tr.absorb_point(w_cm)
    u = tr.squeeze() % q
    zc = _zs_coeffs(zs, q)
    zu = sum(c * pow(u, i, q) for i, c in enumerate(zc)) % q
    ru = (rf[0] + rf[1] * u + rf[2] * u * u) % q
    # L = f - r_f(u) - Z(u) h, and W' its quotient at u
    larr = batched.arr.copy()
    _sub_prefix(larr, [ru], q - 1, q)
    hn = len(h)
    pref = PackedVec(larr[:4 * hn], hn, q)
    larr[:4 * hn] = hr.vec_rlc_pv(q, pref, h, (q - zu) % q).arr
    wp_cm = ck.commit(hsc.poly_quotient(PackedVec(larr, n_max, q), u))
    tr.absorb_point(wp_cm)
    tr.squeeze()
    return HkzgBatchProof(comms, evals, w_cm, wp_cm)


def verify_batch(srs: Srs, claims, proof: HkzgBatchProof,
                 tr: Transcript) -> bool:
    """claims: list of (comm, point, value) matching prove_batch's
    opens (comm may be None = identity)."""
    q = CURVE.order
    if len(proof.comms) != len(claims) or \
            len(proof.evals) != len(claims):
        return False
    for ci, (comm, point, value) in enumerate(claims):
        k = len(point)
        if len(proof.comms[ci]) != k - 1 or \
                len(proof.evals[ci]) != k:
            return False
        for cm in proof.comms[ci]:
            tr.absorb_point(cm)
    r = tr.squeeze() % q or 1
    zs = (r, (-r) % q, r * r % q)
    for ci, (comm, point, value) in enumerate(claims):
        for ev in proof.evals[ci]:
            if len(ev) != 3:
                return False
            for v in ev:
                tr.absorb_scalar(v)
    gamma = tr.squeeze() % q
    inv2 = pow(2, q - 2, q)
    inv2r = pow(2 * r % q, q - 2, q)
    for ci, (comm, point, value) in enumerate(claims):
        xs = [v % q for v in reversed(point)]
        k = len(point)
        for i in range(k):
            er, enr, _ = proof.evals[ci][i]
            nxt = ((1 - xs[i]) * (er + enr) % q * inv2 +
                   xs[i] * (er - enr) % q * inv2r) % q
            want = (proof.evals[ci][i + 1][2] if i + 1 < k
                    else value % q)
            if nxt != want:
                return False
    # batched commitment + evals with the same global gamma stream
    g = 1
    cf: Affine = None
    f_evals = [0, 0, 0]
    for ci, (comm, point, value) in enumerate(claims):
        chain_comms = [comm] + list(proof.comms[ci])
        for pi, cm in enumerate(chain_comms):
            if cm is not None:
                cf = CURVE.add(cf, CURVE.mul(g, cm))
            for j in range(3):
                f_evals[j] = (f_evals[j]
                              + g * proof.evals[ci][pi][j]) % q
            g = g * gamma % q
    rf = _interp3(zs, f_evals, q)
    tr.absorb_point(proof.w)
    u = tr.squeeze() % q
    zc = _zs_coeffs(zs, q)
    zu = sum(c * pow(u, i, q) for i, c in enumerate(zc)) % q
    ru = (rf[0] + rf[1] * u + rf[2] * u * u) % q
    tr.absorb_point(proof.wp)
    tr.squeeze()
    # C_L = C_f - [r_f(u)]G - Z(u) W;  e(C_L + u W', G2) e(-W', tauG2)=1
    cl = CURVE.add(cf, CURVE.neg(CURVE.mul(ru, CURVE.generator)))
    if proof.w is not None:
        cl = CURVE.add(cl, CURVE.neg(CURVE.mul(zu, proof.w)))
    lhs = CURVE.add(cl, CURVE.mul(u, proof.wp)
                    if proof.wp is not None else None)
    return pr.pairing_product_is_one([
        (lhs, srs.g2),
        (CURVE.neg(proof.wp) if proof.wp is not None else None,
         srs.tau_g2),
    ])
