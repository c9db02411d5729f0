"""The port's compression (``lurk_tpu_torch.proof.{mle,ipa,hyperkzg,
spartan}``, the host C++ of ``hostlib.spartan`` and the compress
functions of ``proof.prover_supernova_cycle``) against the JAX package
on the CPU. Integers only: tolerance 0.

- The host C++'s ``chi_table``, ``mle_eval`` and sumchecks on 2^6
  equal the JAX package's ``mle`` functions on the same seeded inputs,
  and the port's ``mle.sumcheck_verify`` walks their round polynomials.
- Spartan on a small random relaxed R1CS (40 constraints, so 2^6
  domains): the port's proof equals the JAX package's field by field on
  BN254 (HyperKZG, its joint opening) and on Grumpkin (IPA), and each
  verifier accepts the other's proof. So do HyperKZG's joint opening
  and the IPA at 2^6 on their own. A JAX Spartan proof with separate
  HyperKZG openings of W and E (the older form, made by patching the
  JAX joint opening), written by the JAX writer, is read and accepted
  by the port, and rejected with one evaluation changed. The host
  C++'s padded matvecs, M vector and matrix evaluations equal the JAX
  Python loops; and ``spartan.compress`` / ``verify_compressed``
  round-trip a two-step Nova fold, which the JAX ``verify_compressed``
  accepts. The JAX side
  takes its Python paths (its host C++ for Spartan, R1CS, SRS and
  generators patched unavailable).
- The rc = 1 cycle fold of ``(+ 1 2)``, compressed by the port: the
  port's ``verify_compressed_sn_cycle`` and the JAX one accept it, and
  both reject it after one sumcheck value is changed. The port proves,
  compresses and verifies in a child process (the module's first
  fixture starts it) while the small cases run here. The public
  parameters of both packages are then read from the port's parameter
  cache (shapes, generators, SRS: the same file layouts). So the
  ``pp_digest`` assertion here compares the port's shape files with
  themselves and is no independent check, and the JAX verifier
  evaluates Spartan's matrices over the port's shapes: it is
  ``test_torch_supernova_cycle.py`` that holds those shapes against
  the JAX package's own synthesis. The JAX MSM's C++ compiles in another child process; the
  JAX package waits for it at its first MSM of 64 or more scalars.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest

import lurk_tpu.cli.lurk_proof as jax_lurk_proof
import lurk_tpu.native.msm as jax_native_msm
import lurk_tpu.native.pedersen as jax_native_pedersen
import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.native.r1cs as jax_native_r1cs
import lurk_tpu.native.spartan as jax_native_spartan
import lurk_tpu.native.srs as jax_native_srs
import lurk_tpu.parallel.sharding as jax_sharding
import lurk_tpu.proof.hyperkzg as jax_hk
import lurk_tpu.proof.ipa as jax_ipa
import lurk_tpu.proof.mle as jax_mle
import lurk_tpu.proof.nova as jax_nova
import lurk_tpu.proof.params_cache as jax_params_cache
import lurk_tpu.proof.prover_supernova_cycle as jax_psc
import lurk_tpu.proof.spartan as jax_spartan
import lurk_tpu.proof.transcript as jax_transcript
from lurk_tpu.curves.weierstrass import CURVE_FOR_FIELD as JAX_CURVES
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.r1cs.cs import ConstraintSystem as JaxCS
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.cli import lurk_proof
from lurk_tpu_torch.curves.weierstrass import BN254_G1, GRUMPKIN
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib import r1cs as hr
from lurk_tpu_torch.hostlib import spartan as hsc
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.proof import hyperkzg as hk
from lurk_tpu_torch.proof import ipa, mle, nova, params_cache, spartan
from lurk_tpu_torch.proof import prover_supernova_cycle as psc
from lurk_tpu_torch.proof.transcript import Transcript
from lurk_tpu_torch.r1cs.cs import ConstraintSystem
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAM = "(+ 1 2)"


@pytest.fixture(scope="module", autouse=True)
def jax_paths(tmp_path_factory):
    """The suite's parameter cache, the JAX package's Python paths for
    everything but its MSM, whose C++ compiles in a child process, and
    no JAX device mesh."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    build = subprocess.Popen(
        [sys.executable, "-c", "from lurk_tpu import native; "
         "assert native.load('msm') is not None"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    msm_available = jax_native_msm.available
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_native_pedersen, jax_native_poseidon,
                    jax_native_r1cs, jax_native_spartan, jax_native_srs):
            mp.setattr(mod, "available", lambda: False)
        mp.setattr(jax_native_msm, "available",
                   lambda: build.wait() == 0 and msm_available())
        mp.setattr(jax_sharding, "_PROVER_MESH", None)
        yield
        assert build.wait() == 0


# The port's side of the compressed proof, run as a child process: the
# rc = 1 cycle fold of the program (through the fork pool: 3 chunks),
# "proved" on stdout once its shapes and keys are cached; then
# compress_sn_cycle, the compressed proof pickled and "compressed"; then
# verify_compressed_sn_cycle and its verdict, while this process runs
# the JAX verifier.
PORT_CHILD = r'''
import pickle, sys
import torch
torch.set_num_threads(1)
from lurk_tpu_torch import native
native.build_host()
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import (
    SuperNovaCycleProver, compress_sn_cycle, verify_compressed_sn_cycle)
from lurk_tpu_torch.store.core import Store
store = Store(BN256_SCALAR, device="cpu")
pp, proof, frames = SuperNovaCycleProver(rc=1, device="cpu") \
    .evaluate_and_prove(store, read_with_default_state(store, sys.argv[2]),
                        limit=50)
print("proved", proof.n, flush=True)
cp = compress_sn_cycle(pp, proof)
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(cp=cp, pp_digest=pp.pp_digest), f)
print("compressed", flush=True)
print("verified", verify_compressed_sn_cycle(pp, cp), flush=True)
'''


@pytest.fixture(scope="module", autouse=True)
def port_child(jax_paths, tmp_path_factory):
    """The port's child process, started before any case runs."""
    out = tmp_path_factory.mktemp("port_compress") / "compressed.pkl"
    child = subprocess.Popen(
        [sys.executable, "-c", PORT_CHILD, str(out), PROGRAM], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, text=True)
    yield child, out
    if child.poll() is None:          # a case failed before it was read
        child.kill()
    child.wait()
    child.stdout.close()


def rand_field(rng, n: int, p: int):
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def challenger(tr):
    def chal(evals):
        for v in evals:
            tr.absorb_scalar(v)
        return tr.squeeze() % tr.curve.order
    return chal


def public_params_from_port_cache():
    """Both packages' cycle public parameters at rc = 1, on the CPU,
    read from the port's parameter cache."""
    store = Store(BN256_SCALAR, device="cpu")
    prover = psc.SuperNovaCycleProver(rc=1, device="cpu")
    pp = psc.sn_cycle_public_params(store, 1, *prover.setup_funcs(),
                                    device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_params_cache, "cache_dir", params_cache.cache_dir)
        jstore = JaxStore(JAX_BN256, use_device=False)
        jprover = jax_psc.SuperNovaCycleProver(rc=1)
        jpp = jax_psc.sn_cycle_public_params(jstore, 1,
                                             *jprover.setup_funcs(), None)
    return pp, jpp


# ---------------------------------------------------------------------------
# mle and the host sumchecks
# ---------------------------------------------------------------------------


def test_mle_matches_jax(jax_paths):
    p = BN256_SCALAR.modulus
    rng = np.random.default_rng(11)
    rs = rand_field(rng, 6, p)
    a = rand_field(rng, 64, p)
    chi = jax_mle.chi_table(rs, p)
    assert hsc.chi_table(rs, p) == chi
    want = jax_mle.mle_eval(a, rs, p)
    assert hsc.mle_eval(a, rs, p) == want
    assert want == sum(x * c for x, c in zip(a, chi)) % p
    assert mle.lagrange_eval(a[:4], rs[0], p) == \
        jax_mle.lagrange_eval(a[:4], rs[0], p)

    # a degree-3 sumcheck of eq * (a*b - u*c - e) over 2^6, in the
    # port's host C++ and the JAX Python
    eq, b, c, e = (rand_field(rng, 64, p) for _ in range(4))
    u = rs[1]

    def comb(vals):
        eq_v, a_v, b_v, c_v, e_v = vals
        return eq_v * (a_v * b_v - u * c_v - e_v) % p

    claim = sum(comb(v) for v in zip(eq, a, b, c, e)) % p
    tr = Transcript(BN254_G1, b"sc.test")
    want = jax_mle.sumcheck_prove(claim, 6, [eq, a, b, c, e], comb, 3, p,
                                  challenger(tr))
    tr = Transcript(BN254_G1, b"sc.test")
    assert hsc.sumcheck1(eq, a, b, c, e, u, p, challenger(tr)) == want
    tr = Transcript(BN254_G1, b"sc.test")
    assert mle.sumcheck_verify(claim, want[0], 3, p, challenger(tr)) \
        == (comb(want[2]), want[1])
    # degree 2: m * z
    claim = sum(x * y for x, y in zip(a, b)) % p
    tr = Transcript(BN254_G1, b"sc.test2")
    want = jax_mle.sumcheck_prove(claim, 6, [a, b],
                                  lambda v: v[0] * v[1] % p, 2, p,
                                  challenger(tr))
    tr = Transcript(BN254_G1, b"sc.test2")
    assert hsc.sumcheck2(a, b, p, challenger(tr)) == want
    bad = [list(r) for r in want[0]]
    bad[2][0] = (bad[2][0] + 1) % p
    tr = Transcript(BN254_G1, b"sc.test2")
    with pytest.raises(ValueError):
        mle.sumcheck_verify(claim, bad, 2, p, challenger(tr))


def test_host_calls_keep_their_scalars_alive_across_threads():
    """``poly_eval``, ``poly_quotient``, ``bind_eo`` and ``mle_eval``
    hand the host C++ a pointer to a scalar's limbs: that array must
    live until the call returns. The compressions run two Spartan
    proofs in threads, so other threads allocate while a call runs;
    here four threads repeat the calls while two more allocate, and
    every result equals the one computed alone."""
    p = BN256_SCALAR.modulus
    rng = np.random.default_rng(5)
    vecs = [PackedVec.pack(rand_field(rng, 1 << 10, p), p)
            for _ in range(4)]
    zs = rand_field(rng, 4, p)

    def run(pv, z):
        return (hsc.poly_eval(pv, z), hsc.poly_quotient(pv, z).ints(),
                hsc.bind_eo(PackedVec(pv.arr.copy(), pv.n, p), z).ints(),
                hsc.mle_eval(pv, [z] * 10, p))

    want = [run(pv, z) for pv, z in zip(vecs, zs)]
    stop = threading.Event()
    got = []

    def churn():
        while not stop.is_set():
            [np.full(4, 2**64 - 1, dtype=np.uint64) for _ in range(50)]

    def work(k):
        got.extend(run(vecs[k], zs[k]) == want[k] for _ in range(10))

    churners = [threading.Thread(target=churn) for _ in range(2)]
    workers = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in churners + workers:
        t.start()
    for t in workers:
        t.join(timeout=60)
    stop.set()
    for t in churners:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in churners + workers)
    assert len(got) == 40 and all(got)


def test_host_fold_chain_matches_jax_python(jax_paths):
    """HyperKZG's packed helpers (even/odd fold, Horner, synthetic
    division) and the padded matvecs against the JAX Python loops."""
    q = BN254_G1.order
    rng = np.random.default_rng(5)
    poly = rand_field(rng, 64, q)
    x, z = rand_field(rng, 2, q)
    got = hsc.bind_eo(PackedVec.pack(poly, q), x).ints()
    assert got == [(poly[2 * j] + x * (poly[2 * j + 1] - poly[2 * j])) % q
                   for j in range(32)]
    pv = PackedVec.pack(poly, q)
    assert hsc.poly_eval(pv, z) == jax_hk._poly_eval(poly, z, q)
    assert hsc.poly_quotient(pv, z).ints() == jax_hk._quotient(poly, z, q)


# ---------------------------------------------------------------------------
# Spartan, HyperKZG and IPA on a small relaxed R1CS
# ---------------------------------------------------------------------------


def small_shape(cs_cls, field, rng_seed: int = 3):
    """40 random sparse constraints over 2 inputs and 40 aux (any
    witness satisfies relaxed R1CS once E is chosen): 2^6 domains."""
    rng = np.random.default_rng(rng_seed)
    p = field.modulus
    cs = cs_cls(field)
    ins = [cs.alloc_input(v) for v in rand_field(rng, 2, p)]
    aux = [cs.alloc(v) for v in rand_field(rng, 40, p)]
    vars_ = [0] + ins + aux
    for _ in range(40):
        lcs = []
        for _k in range(3):
            pick = rng.choice(len(vars_), size=2, replace=False)
            lcs.append({vars_[int(i)]: c for i, c in
                        zip(pick, rand_field(rng, 2, p))})
        cs.enforce(*lcs)
    return cs


def relaxed_instance(nova_mod, shape, ck, seed: int):
    """(instance, witness) with random W and u, E = Az∘Bz − u·Cz."""
    rng = np.random.default_rng(seed)
    p = shape.p
    x = rand_field(rng, shape.num_inputs - 1, p)
    w = rand_field(rng, shape.num_aux, p)
    u = rand_field(rng, 1, p)[0]
    az, bz, cz = shape.matvecs([u] + x + w)
    e = [(a * b - u * c) % p for a, b, c in zip(az, bz, cz)]
    inst = nova_mod.RelaxedInstance(ck.commit(w), ck.commit(e), x, u)
    return inst, w, e


@pytest.fixture(scope="module")
def small(jax_paths):
    """The small shape with its keys on both sides: BN254 (the SRS) and
    Grumpkin, 64 generators each."""
    out = {}
    for curve in (BN254_G1, GRUMPKIN):
        field = curve.scalar
        jcurve = JAX_CURVES[field.name]
        label = b"lurk_tpu.ck." + curve.name.encode()
        shape = nova.R1CSShape(small_shape(ConstraintSystem, field))
        jshape = jax_nova.R1CSShape(small_shape(JaxCS, jcurve.scalar))
        assert shape.digest == jshape.digest
        ck = nova.CommitmentKey.setup(curve, label, 64, device="cpu")
        jck = jax_nova.CommitmentKey.setup(jcurve, label, 64)
        assert ck.gens[:64] == jck.gens[:64]
        inst, w, e = relaxed_instance(nova, shape, ck, 9)
        jinst = jax_nova.RelaxedInstance(inst.comm_w, inst.comm_e,
                                         list(inst.x), inst.u)
        assert (jck.commit(w), jck.commit(e)) == (inst.comm_w, inst.comm_e)
        wit = nova.RelaxedWitness(PackedVec.pack(w, field.modulus),
                                  PackedVec.pack(e, field.modulus))
        assert nova.check_relaxed(shape, inst, wit)
        out[curve.name] = dict(
            pp=nova.PublicParams(shape, curve, ck),
            jpp=jax_nova.PublicParams(jshape, jcurve, jck),
            inst=inst, wit=wit, jinst=jinst,
            jwit=jax_nova.RelaxedWitness(w, e))
    return out


def spartan_to_jax(sp):
    """The port's SpartanProof as the JAX package's dataclasses."""
    def ipa_proof(pf):
        return None if pf is None else jax_ipa.IpaProof(pf.ls, pf.rs,
                                                        pf.a_final)
    joint = sp.hkzg_joint
    if joint is not None:
        joint = jax_hk.HkzgBatchProof(joint.comms, joint.evals, joint.w,
                                      joint.wp)
    return jax_spartan.SpartanProof(
        sp.sc1_polys, sp.claims, sp.sc2_polys, sp.w_eval,
        ipa_proof(sp.ipa_w), ipa_proof(sp.ipa_e), hkzg_joint=joint)


def spartan_to_port(jsp):
    def ipa_proof(pf):
        return None if pf is None else ipa.IpaProof(pf.ls, pf.rs,
                                                    pf.a_final)
    joint = jsp.hkzg_joint
    if joint is not None:
        joint = hk.HkzgBatchProof(joint.comms, joint.evals, joint.w,
                                  joint.wp)
    return spartan.SpartanProof(
        jsp.sc1_polys, tuple(jsp.claims), jsp.sc2_polys, jsp.w_eval,
        ipa_proof(jsp.ipa_w), ipa_proof(jsp.ipa_e), hkzg_joint=joint)


@pytest.mark.parametrize("curve", ["bn254-g1", "grumpkin"])
def test_spartan_matches_jax(small, curve):
    s = small[curve]
    sp = spartan.prove(s["pp"], s["inst"], s["wit"])
    jsp = jax_spartan.prove(s["jpp"], s["jinst"], s["jwit"])
    assert spartan_to_jax(sp) == jsp
    assert (sp.ipa_w is None) == (curve == "bn254-g1")
    assert len(sp.sc1_polys) == len(sp.sc2_polys) - 1 == 6
    assert jax_spartan.verify(s["jpp"], s["jinst"], spartan_to_jax(sp))
    assert spartan.verify(s["pp"], s["inst"], spartan_to_port(jsp))
    bad = spartan_to_port(jsp)
    bad.sc2_polys[3][1] = (bad.sc2_polys[3][1] + 1) % s["pp"].shape.p
    assert not spartan.verify(s["pp"], s["inst"], bad)
    assert not jax_spartan.verify(s["jpp"], s["jinst"], spartan_to_jax(bad))


def test_host_spartan_products_match_jax(small):
    """The Spartan entries of the host C++ (padded matvecs, the split-z
    M vector and the matrix evaluations) against the JAX Python loops on
    the small shape."""
    s = small["grumpkin"]
    shape, jshape = s["pp"].shape, s["jpp"].shape
    p = shape.p
    rng = np.random.default_rng(41)
    n_half, m_pad = jax_spartan._dims(jshape)
    assert spartan._dims(shape) == (n_half, m_pad) == (64, 64)
    z = nova.z_vector(shape, s["inst"].x, s["wit"].w, s["inst"].u)
    padded = hr.matvecs_padded_pv(shape, z, m_pad)
    want = jshape.matvecs(list(z))
    assert [v.ints() for v in padded] == \
        [list(v) + [0] * (m_pad - shape.num_constraints) for v in want]
    rx, ry = rand_field(rng, 6, p), rand_field(rng, 7, p)
    r = rand_field(rng, 1, p)[0]
    chi_rx, chi_ry = jax_mle.chi_table(rx, p), jax_mle.chi_table(ry, p)
    assert hsc.matrix_evals(shape, chi_rx, chi_ry, n_half) == \
        jax_spartan._matrix_evals(jshape, chi_rx, chi_ry, n_half)
    m_vec = [0] * (2 * n_half)
    for i, row in enumerate(jshape.rows):
        for lc, rp in zip(row, (1, r, r * r % p)):
            for j, val in lc.items():
                k = jax_spartan._col_index(jshape, n_half, j)
                m_vec[k] = (m_vec[k] + chi_rx[i] * rp * val) % p
    assert hsc.spartan_mvec(shape, chi_rx, r, n_half).ints() == m_vec


def squaring_chain(cs_cls, field, v: int):
    """A satisfied strict R1CS: 40 squarings from v, the first square as
    the one input (41 constraints, 41 aux: 2^6 domains)."""
    p = field.modulus
    cs = cs_cls(field)
    y = cs.alloc_input(v * v % p)
    cur = cs.alloc(v)
    cs.enforce({cur: 1}, {cur: 1}, {y: 1})
    for _ in range(40):
        nxt = cs.alloc(cs.aux[-1] ** 2 % p)
        cs.enforce({cur: 1}, {cur: 1}, {nxt: 1})
        cur = nxt
    return cs


def test_nova_compression_round_trip(small):
    """spartan.compress / verify_compressed over a two-step Nova fold of
    the squaring chain on the BN254 key; the JAX verify_compressed
    accepts it; a changed step is rejected."""
    s = small["bn254-g1"]
    shape = nova.R1CSShape(squaring_chain(ConstraintSystem, BN256_SCALAR, 3))
    pp = nova.PublicParams(shape, BN254_G1, s["pp"].ck)
    rs = nova.RecursiveSNARK(pp)
    for v in (3, 5):
        cs = squaring_chain(ConstraintSystem, BN256_SCALAR, v)
        rs.prove_step(cs.inputs[1:], cs.aux, check=True)
    rs.z0, rs.zi = [3], [5]
    cp = spartan.compress(pp, rs.finish())
    assert spartan.verify_compressed(pp, cp)
    jshape = jax_nova.R1CSShape(squaring_chain(JaxCS, JAX_BN256, 3))
    jpp = jax_nova.PublicParams(jshape, s["jpp"].curve, s["jpp"].ck)
    jcp = jax_spartan.CompressedProof(
        [(jax_nova.R1CSInstance(inst.comm_w, list(inst.x)), comm_t)
         for inst, comm_t in cp.steps], spartan_to_jax(cp.spartan),
        list(cp.z0), list(cp.zi))
    assert jax_spartan.verify_compressed(jpp, jcp)
    bad = spartan.CompressedProof(cp.steps[:1], cp.spartan, cp.z0, cp.zi)
    assert not spartan.verify_compressed(pp, bad)
    assert not spartan.verify_compressed(pp, dataclasses.replace(cp,
                                                                 steps=[]))


def test_hyperkzg_open_matches_jax(small):
    """The joint opening of two claims at 2^6 and 2^5 on its own (the
    BN254 Spartan case opens W and E of one shape)."""
    s = small["bn254-g1"]
    q = BN254_G1.order
    rng = np.random.default_rng(21)
    polys = [rand_field(rng, 64, q), rand_field(rng, 32, q)]
    points = [rand_field(rng, 6, q), rand_field(rng, 5, q)]
    claims = [(s["pp"].ck.commit(f), x, jax_mle.mle_eval(f, x, q))
              for f, x in zip(polys, points)]
    pf = hk.prove_batch(s["pp"].ck, list(zip(polys, points)),
                        Transcript(BN254_G1, b"hk"))
    jpf = jax_hk.prove_batch(
        jax_hk.load_srs(64), list(zip(polys, points)),
        jax_transcript.Transcript(s["jpp"].curve, b"hk"))
    assert (pf.comms, pf.evals, pf.w, pf.wp) == \
        (jpf.comms, jpf.evals, jpf.w, jpf.wp)
    srs = hk.load_srs(64)
    assert hk.verify_batch(srs, claims, pf, Transcript(BN254_G1, b"hk"))
    assert jax_hk.verify_batch(
        jax_hk.load_srs(64), claims, jax_hk.HkzgBatchProof(
            pf.comms, pf.evals, pf.w, pf.wp),
        jax_transcript.Transcript(s["jpp"].curve, b"hk"))
    bad = [claims[0], (claims[1][0], claims[1][1], (claims[1][2] + 1) % q)]
    assert not hk.verify_batch(srs, bad, pf, Transcript(BN254_G1, b"hk"))
    with pytest.raises(ValueError):
        hk.prove_batch(small["grumpkin"]["pp"].ck, list(zip(polys, points)),
                       Transcript(BN254_G1, b"hk"))


def test_ipa_matches_jax(small):
    s = small["grumpkin"]
    q = GRUMPKIN.order
    rng = np.random.default_rng(31)
    a, b = rand_field(rng, 64, q), rand_field(rng, 64, q)
    c = sum(x * y for x, y in zip(a, b)) % q
    gens = s["pp"].ck.gens
    comm = s["pp"].ck.commit(a)
    pf = ipa.prove(GRUMPKIN, gens, comm, a, b, c, Transcript(GRUMPKIN, b"i"))
    jpf = jax_ipa.prove(s["jpp"].curve, gens, comm, a, b, c,
                        jax_transcript.Transcript(s["jpp"].curve, b"i"))
    assert (pf.ls, pf.rs, pf.a_final) == (jpf.ls, jpf.rs, jpf.a_final)
    assert ipa.verify(GRUMPKIN, gens, comm, b, c, pf,
                      Transcript(GRUMPKIN, b"i"))
    assert not ipa.verify(GRUMPKIN, gens, comm, b, (c + 1) % q, pf,
                          Transcript(GRUMPKIN, b"i"))


def test_separate_hyperkzg_openings_from_a_jax_file(small, tmp_path,
                                                    monkeypatch):
    """The older proof form, verify only. The JAX Spartan prover, its
    joint opening replaced by separate openings of W and E (the JAX
    single-opening ``prove``, one after the other on one transcript),
    gives a proof that, rebuilt with ``hkzg_w``/``hkzg_e``, the JAX
    verifier accepts; the JAX writer writes it to a file. The port reads
    the file, writes it back to the same JSON, accepts it, and rejects
    it with one evaluation changed, as the JAX verifier does."""
    s = small["bn254-g1"]
    q = BN254_G1.order
    monkeypatch.setattr(jax_hk, "prove_batch", lambda srs, opens, tr: [
        jax_hk.prove(srs, poly, point, tr) for poly, point in opens])
    jsp = jax_spartan.prove(s["jpp"], s["jinst"], s["jwit"])
    pw, pe = jsp.hkzg_joint
    jsp = dataclasses.replace(jsp, hkzg_w=pw, hkzg_e=pe, hkzg_joint=None)
    assert jax_spartan.verify(s["jpp"], s["jinst"], jsp)
    path = tmp_path / "spartan.json"
    path.write_text(json.dumps(jax_lurk_proof._spartan_to_json(jsp)))
    d = json.loads(path.read_text())
    assert "hkzg_w" in d and "hkzg_joint" not in d
    sp = lurk_proof._spartan_from_json(d)
    assert sp.hkzg_joint is None and len(sp.hkzg_e.evals) == 6
    assert lurk_proof._spartan_to_json(sp) == d
    assert spartan.verify(s["pp"], s["inst"], sp)
    ev = d["hkzg_e"]["evals"][2]
    ev[1] = f"{(int(ev[1], 16) + 1) % q:x}"
    assert not spartan.verify(s["pp"], s["inst"],
                              lurk_proof._spartan_from_json(d))
    assert not jax_spartan.verify(s["jpp"], s["jinst"],
                                  jax_lurk_proof._spartan_from_json(d))


# ---------------------------------------------------------------------------
# the compressed cycle proof
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compressed(port_child):
    """The port's compressed proof from its child, and both packages'
    public parameters (read once the child's shapes are cached, while
    it compresses)."""
    child, out = port_child
    assert child.stdout.readline().split() == ["proved", "3"]
    pp, jpp = public_params_from_port_cache()
    assert child.stdout.readline().split() == ["compressed"]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["pp_digest"] == pp.pp_digest == jpp.pp_digest
    return pp, got["cp"], jpp, child


def compressed_to_jax(cp):
    rel = lambda u: jax_nova.RelaxedInstance(u.comm_w, u.comm_e,  # noqa
                                             list(u.x), u.u)
    return jax_psc.CompressedSnCycleProof(
        cp.n, list(cp.z0), list(cp.zn), cp.pc_n, [rel(u) for u in cp.u1s],
        rel(cp.u2), jax_nova.R1CSInstance(cp.u2_pending.comm_w,
                                          list(cp.u2_pending.x)),
        cp.comm_t_last, [spartan_to_jax(sp) for sp in cp.spartans1],
        spartan_to_jax(cp.spartan2))


def test_compressed_proof_accepted_by_both(compressed):
    """The JAX verifier here, the port's in the child meanwhile."""
    pp, cp, jpp, child = compressed
    assert cp.n == 3 and len(cp.spartans1) == 1
    assert jax_psc.verify_compressed_sn_cycle(jpp, compressed_to_jax(cp))
    assert child.stdout.readline().split() == ["verified", "True"]
    assert child.wait() == 0


@pytest.mark.parametrize("which", ["sc1_polys", "sc2_polys"])
def test_changed_sumcheck_value_rejected_by_both(compressed, which):
    """One value of the primary Spartan proof's first or second
    sumcheck, changed: both verifiers reject."""
    pp, cp, jpp, _ = compressed
    good = cp.spartans1[0]
    polys = [list(r) for r in getattr(good, which)]
    polys[4][1] = (polys[4][1] + 1) % pp.field1.modulus
    bad = psc.CompressedSnCycleProof(**{
        **cp.__dict__,
        "spartans1": [dataclasses.replace(good, **{which: polys})]})
    assert not psc.verify_compressed_sn_cycle(pp, bad)
    assert not jax_psc.verify_compressed_sn_cycle(jpp,
                                                  compressed_to_jax(bad))
