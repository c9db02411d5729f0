"""Spartan SNARK for relaxed R1CS + CompressedSNARK wrapper.

The port of the JAX package's ``proof/spartan.py``. Its sumchecks,
chi tables, MLE evaluations and sparse matrix products run in the host
C++ (:mod:`..hostlib.spartan`, :mod:`..hostlib.r1cs`), the JAX
package's native branch, with no Python path; the JAX package's
Python loops (its ``proof/mle.py``) are their plain versions, held in
``tests/test_torch_compress.py``. The PCS openings commit on the
instance's key: HyperKZG over BN254 (:mod:`.hyperkzg`, so K6 on a CUDA
key), IPA over the other curves (:mod:`.ipa`, the host Pippenger).

Functionality parity target: arecibo's `spartan::snark::
RelaxedR1CSSNARK` + `CompressedSNARK` as driven by the reference's
`nova::Proof::compress` / `verify` (reference src/proof/
nova.rs:331-373, 376-439; SS1/SS2 type wiring nova.rs:56-71). The
reference compresses the final folded accumulator with Spartan
(sumcheck reduction of relaxed R1CS satisfiability to MLE openings) and
opens the witness commitments with the engine's PCS (IPA for Pasta,
HyperKZG for BN256).

Layout (mirrors Spartan's split-z convention): with
N = next_pow2(max(num_aux, num_inputs)), the z MLE has domain 2N —
first half holds the public part (u | X | 0..), second half the
witness (W | 0..). Binding the top variable splits public/witness, so
Z~(ry) = (1 - ry0) * pub~(ry[1:]) + ry0 * W~(ry[1:]) and only W needs a
PCS opening.

Protocol:
  sumcheck 1 (degree 3, log m rounds):
      0 = sum_x eq(tau, x) * (Az~(x) Bz~(x) - u Cz~(x) - E~(x))
    ending with claims (Az~, Bz~, Cz~, E~)(rx).
  sumcheck 2 (degree 2, log 2N rounds), batching r:
      Az~(rx) + r Bz~(rx) + r^2 Cz~(rx) = sum_y M~(y) Z~(y),
      M = (A + r B + r^2 C)^T chi(rx)
    ending with a claim the verifier checks by evaluating the sparse
    matrices at (rx, ry) directly (O(nnz), arecibo's non-preprocessing
    SNARK does the same) plus the two IPA openings W~(ry[1:]), E~(rx).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..curves.weierstrass import Affine
from ..hostlib import r1cs as hr
from ..hostlib import spartan as hsc
from ..utils import metrics, tracing
from . import hyperkzg as hk
from . import ipa
from .mle import next_pow2, pad_pow2, sumcheck_verify
from .nova import (
    FoldingProof, PublicParams, R1CSInstance, R1CSShape, RelaxedInstance,
    RelaxedWitness, _absorb_relaxed, fold_challenge, fold_instance,
    z_vector,
)
from .transcript import Transcript


@dataclasses.dataclass
class SpartanProof:
    sc1_polys: List[List[int]]       # log m rounds of 4 evals
    claims: Tuple[int, int, int, int]  # Az~, Bz~, Cz~, E~ at rx
    sc2_polys: List[List[int]]       # log 2N rounds of 3 evals
    w_eval: int                      # W~(ry[1:])
    ipa_w: Optional[ipa.IpaProof]
    ipa_e: Optional[ipa.IpaProof]
    # BN254's engine (nova.rs:56-71 Bn256EngineKZG): pairing-verified
    # HyperKZG openings instead of IPA. W and E open jointly via the
    # Shplonk batch argument; the separate openings of older proofs are
    # verified, never made.
    hkzg_w: Optional[hk.HkzgProof] = None
    hkzg_e: Optional[hk.HkzgProof] = None
    hkzg_joint: Optional[hk.HkzgBatchProof] = None


def _uses_kzg(pp: PublicParams) -> bool:
    return pp.curve.name == "bn254-g1"


def _dims(shape: R1CSShape) -> Tuple[int, int]:
    n_half = next_pow2(max(shape.num_aux, shape.num_inputs))
    m_pad = next_pow2(max(shape.num_constraints, 2))
    return n_half, m_pad


def _pub_vector(shape: R1CSShape, inst: RelaxedInstance,
                n_half: int) -> List[int]:
    return pad_pow2([inst.u % shape.p] + [v % shape.p for v in inst.x],
                    n_half)


def _transcript(pp: PublicParams, inst: RelaxedInstance) -> Transcript:
    tr = Transcript(pp.curve, b"lurk_tpu.spartan")
    tr.absorb(int(pp.shape.digest[:32], 16))
    _absorb_relaxed(tr, inst)
    return tr


def prove(pp: PublicParams, inst: RelaxedInstance,
          wit: RelaxedWitness) -> SpartanProof:
    """Each phase's host-clock seconds go to :mod:`..utils.metrics`
    (``spartan.matvecs``, ``spartan.sumcheck1``, ``spartan.mvec``,
    ``spartan.sumcheck2``, ``spartan.kzg_open`` or
    ``spartan.ipa_open``)."""
    shape = pp.shape
    p = shape.p
    n_half, m_pad = _dims(shape)
    s_x = m_pad.bit_length() - 1
    tr = _transcript(pp, inst)
    tau = [tr.squeeze() % p for _ in range(s_x)]

    with metrics.timed("spartan.matvecs"):
        z = z_vector(shape, inst.x, wit.w, inst.u)
        az, bz, cz = hr.matvecs_padded_pv(shape, z, m_pad)
        e_vec = hr.pad_pv(wit.e, m_pad, p)
        eq_tau = hsc.chi_table_pv(tau, p)
    u = inst.u % p

    def chal(evals):
        for v in evals:
            tr.absorb_scalar(v)
        return tr.squeeze() % p

    with metrics.timed("spartan.sumcheck1"):
        sc1_polys, rx, finals1 = hsc.sumcheck1(eq_tau, az, bz, cz, e_vec,
                                               u, p, chal)
    _, az_r, bz_r, cz_r, e_r = finals1
    for v in (az_r, bz_r, cz_r, e_r):
        tr.absorb_scalar(v)
    r = tr.squeeze() % p

    # M = (A + r B + r^2 C)^T chi(rx) over the split-z domain
    with metrics.timed("spartan.mvec"):
        chi_rx = hsc.chi_table_pv(rx, p)
        m_vec = hsc.spartan_mvec(shape, chi_rx, r, n_half)
        w_padded = hr.pad_pv(wit.w, n_half, p)
        z_split = hr.pv_concat(_pub_vector(shape, inst, n_half), w_padded,
                               p)
    with metrics.timed("spartan.sumcheck2"):
        sc2_polys, ry, _finals2 = hsc.sumcheck2(m_vec, z_split, p, chal)
        w_eval = hsc.mle_eval(w_padded, ry[1:], p)
    tr.absorb_scalar(w_eval)

    if _uses_kzg(pp):
        with metrics.timed("spartan.kzg_open"):
            joint = hk.prove_batch(pp.ck, [(w_padded, ry[1:]),
                                           (e_vec, rx)], tr)
        return SpartanProof(sc1_polys, (az_r, bz_r, cz_r, e_r),
                            sc2_polys, w_eval, None, None, hkzg_joint=joint)
    with metrics.timed("spartan.ipa_open"):
        ipa_w = ipa.prove(pp.curve, pp.ck.gens, inst.comm_w,
                          w_padded.ints(), hsc.chi_table(ry[1:], p),
                          w_eval, tr)
        ipa_e = ipa.prove(pp.curve, pp.ck.gens, inst.comm_e, e_vec.ints(),
                          chi_rx.ints(), e_r, tr)
    return SpartanProof(sc1_polys, (az_r, bz_r, cz_r, e_r), sc2_polys,
                        w_eval, ipa_w, ipa_e)


@tracing.instrument("spartan.verify")
def verify(pp: PublicParams, inst: RelaxedInstance,
           proof: SpartanProof) -> bool:
    """Spans: ``spartan.verify.sumchecks`` (both sumchecks' replay),
    ``spartan.verify.matrix_evals`` (the matrices and Z~ at (rx, ry))
    and ``spartan.verify.pcs`` (the HyperKZG or IPA check, the SRS's
    load included)."""
    shape = pp.shape
    p = shape.p
    n_half, m_pad = _dims(shape)
    s_x = m_pad.bit_length() - 1
    s_y = (2 * n_half).bit_length() - 1
    if len(proof.sc1_polys) != s_x or len(proof.sc2_polys) != s_y:
        return False
    # comm_w/comm_e may be the identity (e.g. a 1-step fold has E = 0);
    # the PCS opening checks remain sound for identity commitments
    tr = _transcript(pp, inst)
    tau = [tr.squeeze() % p for _ in range(s_x)]

    def chal(evals):
        for v in evals:
            tr.absorb_scalar(v)
        return tr.squeeze() % p

    with tracing.span("spartan.verify.sumchecks"):
        try:
            e1, rx = sumcheck_verify(0, proof.sc1_polys, 3, p, chal)
        except ValueError:
            return False
        az_r, bz_r, cz_r, e_r = (v % p for v in proof.claims)
        # eq(tau, rx)
        eq_t = 1
        for t, x in zip(tau, rx):
            eq_t = eq_t * (t * x + (1 - t) * (1 - x)) % p
        if e1 != eq_t * (az_r * bz_r - (inst.u % p) * cz_r - e_r) % p:
            return False
        for v in (az_r, bz_r, cz_r, e_r):
            tr.absorb_scalar(v)
        r = tr.squeeze() % p
        r2 = r * r % p
        claim2 = (az_r + r * bz_r + r2 * cz_r) % p
        try:
            e2, ry = sumcheck_verify(claim2, proof.sc2_polys, 2, p, chal)
        except ValueError:
            return False

    with tracing.span("spartan.verify.matrix_evals"):
        chi_rx = hsc.chi_table_pv(rx, p)
        a_eval, b_eval, c_eval = hsc.matrix_evals(
            shape, chi_rx, hsc.chi_table_pv(ry, p), n_half)
        chi_ry1 = hsc.chi_table(ry[1:], p)
        m_eval = (a_eval + r * b_eval + r2 * c_eval) % p
        # Z~(ry) from the public part + claimed W opening
        pub = _pub_vector(shape, inst, n_half)
        pub_eval = sum(v * c for v, c in zip(pub[:shape.num_inputs],
                                             chi_ry1[:shape.num_inputs])) % p
        w_eval = proof.w_eval % p
        z_eval = ((1 - ry[0]) * pub_eval + ry[0] * w_eval) % p
    if e2 != m_eval * z_eval % p:
        return False
    tr.absorb_scalar(w_eval)
    with tracing.span("spartan.verify.pcs"):
        if _uses_kzg(pp):
            srs = hk.load_srs(max(n_half, m_pad))
            if proof.hkzg_joint is not None:
                return hk.verify_batch(
                    srs, [(inst.comm_w, ry[1:], w_eval),
                          (inst.comm_e, rx, e_r)], proof.hkzg_joint, tr)
            if proof.hkzg_w is None or proof.hkzg_e is None:
                return False
            return (hk.verify(srs, inst.comm_w, ry[1:], w_eval,
                              proof.hkzg_w, tr)
                    and hk.verify(srs, inst.comm_e, rx, e_r, proof.hkzg_e,
                                  tr))
        if proof.ipa_w is None or proof.ipa_e is None:
            return False
        if not ipa.verify(pp.curve, pp.ck.gens, inst.comm_w, chi_ry1,
                          w_eval, proof.ipa_w, tr):
            return False
        return ipa.verify(pp.curve, pp.ck.gens, inst.comm_e, chi_rx.ints(),
                          e_r, proof.ipa_e, tr)


# ---------------------------------------------------------------------------
# CompressedSNARK (fold chain + Spartan proof of the final accumulator)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompressedProof:
    """Succinct proof: the fold chain (instances + cross-term
    commitments, no witnesses) and one Spartan proof of the final
    relaxed accumulator (nova.rs:331-373 `Proof::Compressed` parity —
    the final witness never leaves the prover)."""

    steps: List[Tuple[R1CSInstance, Affine]]
    spartan: SpartanProof
    z0: List[int]
    zi: List[int]


def _fold_chain(pp: PublicParams,
                steps: List[Tuple[R1CSInstance, Affine]]
                ) -> RelaxedInstance:
    shape = pp.shape
    acc = RelaxedInstance.default(shape)
    for inst, comm_t in steps:
        r = fold_challenge(pp.curve, shape.digest, acc, inst, comm_t)
        acc = fold_instance(pp.curve, acc, inst, comm_t, r, shape.p)
    return acc


def compress(pp: PublicParams, proof: FoldingProof) -> CompressedProof:
    if not proof.steps:
        raise ValueError("cannot compress an empty fold chain")
    acc = _fold_chain(pp, proof.steps)
    sp = prove(pp, acc, proof.final_witness)
    return CompressedProof(proof.steps, sp, proof.z0, proof.zi)


def verify_compressed(pp: PublicParams, proof: CompressedProof,
                      io_chain_check=None) -> bool:
    shape = pp.shape
    if not proof.steps:
        return False
    if any(len(inst.x) != shape.num_inputs - 1 for inst, _ in proof.steps):
        return False
    acc = _fold_chain(pp, proof.steps)
    if io_chain_check is not None:
        if not io_chain_check([inst.x for inst, _ in proof.steps]):
            return False
    return verify(pp, acc, proof.spartan)
