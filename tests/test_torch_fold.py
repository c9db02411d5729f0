"""The port's fold (``lurk_tpu_torch.proof.{transcript,nova,prover}`` and
the host C++ of ``hostlib.r1cs``) against the JAX package on the CPU.
Integers only: tolerance 0.

- The transcript: the same absorbs give the same squeeze over BN254
  (scalars absorbed whole) and Pallas (scalars split in two limbs).
- The host R1CS (matvecs, cross-term, relaxed check, witness RLC) on a
  step instance at rc = 1 of ``(+ 1 (* 2 3))`` equals the JAX package's
  Python loops (``lurk_tpu.native.r1cs.available`` patched to False, so
  its C++ is not compiled here).
- The fold: ``NovaProver(rc=1, device="cpu")`` proves
  ``((lambda (x) (* x x)) 7)`` over bn256 into the JAX ``NovaProver``'s
  proof, field by field; each package's verifier accepts the other's
  proof and both reject a changed final witness. The JAX side commits
  through its own host C++ MSM (built into ``$LURK_TPU_CACHE``), the
  port's CPU key through ``csrc/host/msm.cpp`` (the Python
  ``Curve.pippenger`` would take seconds for each of the file's 22
  commits of 9k-11k scalars); keys are 2^14 on each side.
- ``check_steps`` and the shape cache (read back by the port and by
  the JAX package).
- Packed commits: ``CommitmentKey.commit(PackedVec)`` equals the commit
  of the ints, ``Curve.pippenger`` and the MSM's plain version reached
  through ``MsmTable.msm_words_async``.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import lurk_tpu.native as jax_native
import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.native.r1cs as jax_native_r1cs
import lurk_tpu.parallel.sharding as jax_sharding
from lurk_tpu.curves.weierstrass import BN254_G1 as JAX_BN254
from lurk_tpu.curves.weierstrass import PALLAS as JAX_PALLAS
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.proof import hyperkzg as jax_hyperkzg
from lurk_tpu.proof import nova as jax_nova
from lurk_tpu.proof import params_cache as jax_params_cache
from lurk_tpu.proof import prover as jax_prover
from lurk_tpu.proof.prover import NovaProver as JaxNovaProver
from lurk_tpu.proof.transcript import Transcript as JaxTranscript
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.curves.weierstrass import BN254_G1, PALLAS
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib import r1cs as hr
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.lem import eval_step, evaluate
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import hyperkzg, nova, params_cache, prover
from lurk_tpu_torch.proof.multiframe import MultiFrame
from lurk_tpu_torch.proof.prover import NovaProver
from lurk_tpu_torch.proof.transcript import Transcript
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

SQUARE = "((lambda (x) (* x x)) 7)"
ROOT = pathlib.Path(__file__).resolve().parent.parent
P = BN256_SCALAR.modulus


@pytest.fixture(scope="module")
def jax_host_paths(tmp_path_factory):
    """A temporary parameter cache (as tests/test_nova.py), the JAX
    package's Python R1CS and Poseidon trace, and no JAX device mesh.
    Both packages' SRS and public parameters start empty in memory: a
    key takes the length of the SRS already there, which another
    module of the same process may have grown."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_r1cs, "available", lambda: False)
        mp.setattr(jax_native_poseidon, "available", lambda: False)
        mp.setattr(jax_sharding, "_PROVER_MESH", None)
        for mod in (jax_hyperkzg, hyperkzg):
            mp.setattr(mod, "_SRS_MEM", {})
        for mod in (jax_prover, prover):
            mp.setattr(mod, "_PP_CACHE", {})
        yield


# ---------------------------------------------------------------------------
# transcript
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curves", [(BN254_G1, JAX_BN254),
                                    (PALLAS, JAX_PALLAS)],
                         ids=["bn254", "pallas"])
def test_transcript_matches_jax(curves):
    curve, jcurve = curves
    rng = np.random.default_rng(7)
    big = [int.from_bytes(rng.bytes(32), "little") % curve.order
           for _ in range(3)] + [curve.order - 1]
    point = curve.mul(5, curve.generator)
    tr, jtr = Transcript(curve, b"t.test"), JaxTranscript(jcurve, b"t.test")
    out = []
    for t in (tr, jtr):
        t.absorb(curve.p + 3)
        for v in big:
            t.absorb_scalar(v)
        t.absorb_point(point)
        t.absorb_point(None)
        first = t.squeeze()
        t.absorb_scalar(0)
        out.append((first, t.squeeze()))
    assert out[0] == out[1]
    assert curve.order - 1 > curve.p or curve.name == "bn254-g1"


# ---------------------------------------------------------------------------
# host R1CS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_pair():
    """The shape and the first two (x, w) of ``(+ 1 (* 2 3))`` at rc=1."""
    store = Store(BN256_SCALAR, device="cpu")
    frames = evaluate(None, read_with_default_state(store, "(+ 1 (* 2 3))"),
                      store, 100)
    store.hydrate_z_cache()
    step = eval_step()
    m0, m1 = MultiFrame.from_frames(frames, 1, step, store)[:2]
    x0, w0, cs = m0.instance(step, store)
    x1, w1, _ = m1.instance(step, store, witness_only=True)
    return cs, nova.R1CSShape(cs), (x0, w0), (x1, w1)


def test_host_r1cs_matches_jax_python(jax_host_paths, step_pair):
    cs, shape, (x0, w0), (x1, w1) = step_pair
    jshape = jax_nova.R1CSShape(cs)       # the same rows, JAX's loops
    assert jshape.digest == shape.digest
    z1 = [1] + x1 + w1
    assert shape.matvecs(z1) == jshape.matvecs(z1)
    assert hr.matvecs_pv(shape, z1).ints() == sum(jshape.matvecs(z1), [])
    assert nova.check_strict(shape, x0, w0)
    assert jax_nova.check_strict(jshape, x0, w0)

    # fold step 1 into step 0 by hand: T, then u = 1 + r, E = r T
    r = 0x1234567890abcdef1234567890abcdef % P
    acc = nova.RelaxedInstance(None, None, x0, 1)
    jacc = jax_nova.RelaxedInstance(None, None, x0, 1)
    wit = nova.RelaxedWitness(PackedVec.pack(w0, P),
                              PackedVec.zeros(shape.num_constraints, P))
    jwit = jax_nova.RelaxedWitness(w0, [0] * shape.num_constraints)
    t = nova.cross_term(shape, acc, wit, x1, w1)
    jt = jax_nova.cross_term(jshape, jacc, jwit, x1, w1)
    assert isinstance(t, PackedVec) and t.ints() == jt
    assert any(t.ints())
    folded = nova.fold_witness(P, wit, PackedVec.pack(w1, P), t, r)
    jfolded = jax_nova.fold_witness(P, jwit, w1, jt, r)
    assert folded.w.ints() == jfolded.w and folded.e.ints() == jfolded.e
    assert hr.vec_rlc(P, w0, w1, r) == jfolded.w
    x = [(a + r * b) % P for a, b in zip(x0, x1)]
    inst = nova.RelaxedInstance(None, None, x, 1 + r)
    jinst = jax_nova.RelaxedInstance(None, None, x, 1 + r)
    assert nova.check_relaxed(shape, inst, folded)
    assert jax_nova.check_relaxed(jshape, jinst, jfolded)
    folded.e[5] = (folded.e[5] + 1) % P
    jfolded.e[5] = (jfolded.e[5] + 1) % P
    assert not nova.check_relaxed(shape, inst, folded)
    assert not jax_nova.check_relaxed(jshape, jinst, jfolded)
    # the cached form: (Az1|Bz1|Cz1) of the accumulator gives the same T
    abc1 = hr.matvecs_pv(shape, nova.z_vector(shape, x0, w0, 1))
    t2, abc2 = hr.cross_term_cached(shape, abc1, 1,
                                    nova.z_vector(shape, x1, w1, 1))
    assert t2.ints() == jt
    assert abc2.ints() == sum(jshape.matvecs(z1), [])
    assert hr.pad_pv(w1, len(w1) + 3, P).ints() == w1 + [0, 0, 0]


def test_packed_vectors_reduce_and_reject():
    """Values of p or more are reduced one by one (p - 1 shares p's top
    limb), a vector with a negative value whole."""
    for big in ([P + 5, P - 1, 3, (1 << 256) - 1, 2 * P],
                [P + 5, -1, (1 << 256) - 1, 0]):
        assert PackedVec.pack(big, P).ints() == [v % P for v in big]
    assert hr.pv_concat([P + 1, 2], [3], P).ints() == [1, 2, 3]
    with pytest.raises(ValueError):
        PackedVec.pack(PackedVec.pack([1], P), P - 2)
    vec = PackedVec.zeros(4, P)
    vec[2] = 9
    assert vec.ints() == [0, 0, 9, 0]


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proofs(jax_host_paths):
    """Both packages' proofs of SQUARE. The JAX side's host C++ (its MSM
    and SRS, about 6 s of g++ each when its cache is cold) compiles
    while the port proves: the SRS in a child process, the MSM in a
    thread (the JAX package builds one library at a time per process)."""
    srs_build = subprocess.Popen(
        [sys.executable, "-c", "from lurk_tpu import native; "
         "native.load('srs')"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    msm_build = threading.Thread(target=jax_native.load, args=("msm",))
    msm_build.start()
    try:
        store = Store(BN256_SCALAR, device="cpu")
        pp, proof, frames = NovaProver(rc=1, device="cpu") \
            .evaluate_and_prove(store, read_with_default_state(store, SQUARE),
                                limit=50)
    finally:
        msm_build.join()
        srs_build.wait()
    jstore = JaxStore(JAX_BN256, use_device=False)
    jpp, jproof, jframes = JaxNovaProver(rc=1).evaluate_and_prove(
        jstore, jax_read(jstore, SQUARE), limit=50)
    assert store.fetch_num(frames[-1].output[0]) == 49
    return pp, proof, jpp, jproof


def to_jax(proof) -> "jax_nova.FoldingProof":
    """The port's FoldingProof as the JAX package's dataclasses."""
    steps = [(jax_nova.R1CSInstance(inst.comm_w, list(inst.x)), comm_t)
             for inst, comm_t in proof.steps]
    wit = jax_nova.RelaxedWitness(list(proof.final_witness.w),
                                  list(proof.final_witness.e))
    return jax_nova.FoldingProof(steps, wit, list(proof.z0), list(proof.zi))


def to_port(jproof) -> "nova.FoldingProof":
    """The JAX package's FoldingProof as the port's dataclasses."""
    steps = [(nova.R1CSInstance(inst.comm_w, list(inst.x)), comm_t)
             for inst, comm_t in jproof.steps]
    wit = nova.RelaxedWitness(PackedVec.pack(list(jproof.final_witness.w), P),
                              PackedVec.pack(list(jproof.final_witness.e), P))
    return nova.FoldingProof(steps, wit, list(jproof.z0), list(jproof.zi))


def test_fold_matches_jax(proofs):
    pp, proof, jpp, jproof = proofs
    assert len(pp.ck.gens) == len(jpp.ck.gens) == 1 << 14
    assert pp.shape.digest == jpp.shape.digest
    assert len(proof.steps) == len(jproof.steps) == 6
    for (inst, comm_t), (jinst, jcomm_t) in zip(proof.steps, jproof.steps):
        assert (inst.comm_w, inst.x, comm_t) == \
            (jinst.comm_w, jinst.x, jcomm_t)
    assert proof.steps[0][1] is None          # step 0 folds into zero
    assert proof.final_witness.w.ints() == list(jproof.final_witness.w)
    assert proof.final_witness.e.ints() == list(jproof.final_witness.e)
    assert (proof.z0, proof.zi) == (jproof.z0, jproof.zi)


def test_verifiers_accept_each_others_proofs(proofs):
    pp, proof, jpp, jproof = proofs
    assert JaxNovaProver.verify(jpp, to_jax(proof))
    assert NovaProver.verify(pp, to_port(jproof))


def test_verifiers_reject_a_changed_final_witness(proofs):
    pp, proof, jpp, jproof = proofs
    bad = to_port(jproof)
    bad.final_witness.w[7] = (bad.final_witness.w[7] + 1) % P
    assert not NovaProver.verify(pp, bad)
    assert not JaxNovaProver.verify(jpp, to_jax(bad))
    bad = to_port(jproof)
    bad.steps = bad.steps[:-1]
    assert not NovaProver.verify(pp, bad)
    bad.steps = []
    assert not NovaProver.verify(pp, bad)


def test_check_steps_proves_and_rejects_a_bad_step(jax_host_paths):
    """check_steps: step 0 fully synthesized with every constraint
    checked and each step's witness checked before it folds; a changed
    witness raises."""
    store = Store(BN256_SCALAR, device="cpu")
    pp, proof, _ = NovaProver(rc=1, check_steps=True, device="cpu") \
        .evaluate_and_prove(store, read_with_default_state(store, "(+ 1 2)"),
                            limit=20)
    assert len(proof.steps) == 3 and NovaProver.verify(pp, proof)
    rs = nova.RecursiveSNARK(pp)
    x = proof.steps[0][0].x
    with pytest.raises(ValueError):
        rs.prove_step(x, [1] * pp.shape.num_aux, check=True)


def test_shape_cache_round_trip(step_pair, tmp_path, monkeypatch):
    """save_shape -> load_shape keeps the digest, counts and rows; the
    loaded shape's CSR arrays register with the host R1CS; the JAX
    package reads the same file."""
    monkeypatch.setattr(params_cache, "cache_dir", lambda: tmp_path)
    monkeypatch.setattr(jax_params_cache, "cache_dir", lambda: tmp_path)
    monkeypatch.setattr(hr, "_HANDLES", {})
    cs, shape, (x0, w0), (x1, w1) = step_pair
    params_cache.save_shape("k", shape)
    got = params_cache.load_shape("k", BN256_SCALAR)
    assert (got.digest, got.num_inputs, got.num_aux, got.num_constraints) \
        == (shape.digest, shape.num_inputs, shape.num_aux,
            shape.num_constraints)
    z1 = [1] + x1 + w1
    assert got.matvecs(z1) == shape.matvecs(z1)
    assert [got.rows[k] for k in (0, 7, len(got.rows) - 1)] == \
        [tuple({v: c % P for v, c in lc.items()} for lc in shape.rows[k])
         for k in (0, 7, len(shape.rows) - 1)]
    assert params_cache.cached_shape("k", BN256_SCALAR, None) \
        .digest == shape.digest
    assert params_cache.load_shape("other", BN256_SCALAR) is None
    assert jax_params_cache.load_shape("k", JAX_BN256).digest == shape.digest


def test_shape_digest_and_csr_from_one_walk(step_pair):
    """``R1CSShape`` takes its digest and its CSR arrays from one walk of
    the rows (``hr.csr_and_digest``): the digest equals
    ``ConstraintSystem.shape_digest`` (the JAX package's), the arrays the
    rows read one by one, also with a coefficient of p or more and one
    of 0 appended."""
    from lurk_tpu_torch.hostlib.fastpack import pack_ints
    from lurk_tpu_torch.r1cs.cs import ConstraintSystem
    cs, shape, _, _ = step_pair
    assert shape.digest == cs.shape_digest()
    odd = ConstraintSystem(BN256_SCALAR)
    odd.num_inputs, odd.aux = cs.num_inputs, cs.aux
    odd.constraints = cs.constraints[:50] + [
        ({0: P + 5, 3: 0}, {1: 1}, {}), ({}, {}, {2: P - 1, 1: 7})]
    csr, digest = hr.csr_and_digest(odd.constraints, odd.num_inputs,
                                    odd.num_aux, P)
    assert digest == odd.shape_digest()
    for k, (indptr, idx, coef) in enumerate(csr):
        entries = [sorted(row[k].items()) for row in odd.constraints]
        assert indptr.tolist() == np.cumsum(
            [0] + [len(e) for e in entries]).tolist()
        assert idx.tolist() == [v for e in entries for v, _ in e]
        assert np.array_equal(coef, pack_ints(
            [c % P for e in entries for _, c in e]))


# ---------------------------------------------------------------------------
# packed commits
# ---------------------------------------------------------------------------


def test_packed_commit_matches_ints_and_plain(proofs):
    pp = proofs[0]
    key = pp.ck
    rng = np.random.default_rng(3)
    ints = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(70)]
    ints[1] = 0
    packed = PackedVec.pack(ints, P)
    want = BN254_G1.pippenger(ints, key.gens[:70])
    assert key.commit(packed) == key.commit(ints) == want
    assert key.commit_async(packed)() == want
    assert key.commit(PackedVec.pack(ints[:10], P)) == \
        BN254_G1.pippenger(ints[:10], key.gens[:10])
    table = nova.MsmTable.build(BN254_G1, key.gens[:70], "cpu")
    words = torch.from_numpy(packed.arr.view(np.int32).reshape(70, 8))
    assert nova.to_affine(BN254_G1, table.msm_words_async(words)) == want
    with pytest.raises(ValueError):
        key.commit(PackedVec.pack(ints, P - 2))
