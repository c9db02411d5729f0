"""The port's Nova cycle backend (``lurk_tpu_torch.proof.{nova_cycle,
prover_cycle,witness_pool}``) against the JAX package on the CPU.
Integers only: tolerance 0.

- ``CycleNovaProver(rc=1, device="cpu")`` proves ``(+ 1 2)`` (3 frames,
  so 3 steps: the fork pool of step witnesses runs) into the JAX
  ``CycleNovaProver``'s proof, field by field: ``pp_digest``, the shape
  digests and counts, ``u1``, ``w1``, ``u2``, ``u2_pending``,
  ``comm_t_last`` and ``w2_folded``.
- Each package's verifier accepts the other's proof; both reject a
  changed ``zn`` and a changed entry of ``w2_folded``.
- The JAX ``verify_compressed_cycle`` accepts the port's compressed
  proof, as the port's does; both reject it after a changed ``zn``.
- The shared pool's step witnesses equal the inline ones.

The JAX side proves in a child process, with its host C++ (built into
``$LURK_TPU_CACHE``, one g++ per library, all at once), while this
process synthesizes the JAX secondary shape for it and then the port
proves and compresses; this process then builds the JAX public
parameters from the shapes and keys that the child cached.
"""

import dataclasses
import hashlib
import os
import pathlib
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.parallel.sharding as jax_sharding
import lurk_tpu.proof.augmented as jax_aug
import lurk_tpu.proof.nova as jax_nova
import lurk_tpu.proof.nova_cycle as jax_nova_cycle
import lurk_tpu.proof.params_cache as jax_params_cache
import lurk_tpu.proof.prover_cycle as jax_pcy
from lurk_tpu.curves.weierstrass import CURVE_FOR_FIELD as JAX_CURVES
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.r1cs.cs import ConstraintSystem as JaxCS
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch import native
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import nova, nova_cycle, witness_pool
from lurk_tpu_torch.proof import prover_cycle as pcy
from lurk_tpu_torch.proof.multiframe import MultiFrame
from lurk_tpu_torch.store.core import Store
from test_torch_compress import spartan_to_jax
from test_torch_field import one_torch_thread  # noqa: F401

PROGRAM = "(+ 1 2)"
ROOT = pathlib.Path(__file__).resolve().parent.parent
P1 = BN256_SCALAR.modulus

# The JAX side, run as a child process: the JAX host libraries that its
# fold and its compressed verifier use (msm, srs, pedersen, r1cs,
# spartan) compile in grandchildren while it synthesizes its shapes, and
# each load waits for its build; its Poseidon runs its Python path (its
# C++ takes longer to compile than the whole prove). CycleNovaProver
# (rc=1) then proves the program (no fork pool: the suite sets
# LURK_TPU_PERF=parallel-steps-only), and the proof is written out as
# plain ints and tuples. The libraries stay in $LURK_TPU_CACHE for this
# process.
JAX_CHILD = r'''
import pickle, subprocess, sys
import lurk_tpu.native as native
builds = {n: subprocess.Popen([sys.executable, "-c",
                               "from lurk_tpu import native; "
                               f"assert native.load({n!r}) is not None"])
          for n in ("msm", "srs", "pedersen", "r1cs", "spartan")}
load = native.load
def load_when_built(name):
    if name in builds and builds.pop(name).wait() != 0:
        raise RuntimeError(f"JAX host library {name} did not build")
    return load(name)
native.load = load_when_built
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.parser import read_with_default_state
from lurk_tpu.proof.prover_cycle import CycleNovaProver
from lurk_tpu.store.core import Store
store = Store(BN256_SCALAR, use_device=False)
pp, proof, frames = CycleNovaProver(rc=1).evaluate_and_prove(
    store, read_with_default_state(store, sys.argv[2]), limit=50)
assert all(b.wait() == 0 for b in builds.values())
rel = lambda u: (u.comm_w, u.comm_e, list(u.x), u.u)
wit = lambda w: (list(w.w), list(w.e))
shapes = [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
          for s in (pp.shape1, pp.shape2)]
out = dict(pp_digest=pp.pp_digest, shapes=shapes,
           gens=(len(pp.ck1.gens), len(pp.ck2.gens)), n=proof.n,
           z0=proof.z0, zn=proof.zn, u1=rel(proof.u1), w1=wit(proof.w1),
           u2=rel(proof.u2),
           u2_pending=(proof.u2_pending.comm_w, list(proof.u2_pending.x)),
           comm_t_last=proof.comm_t_last, w2_folded=wit(proof.w2_folded))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def jax_paths(tmp_path_factory):
    """The suite's parameter cache, the JAX package's Python Poseidon
    (its C++ is not compiled here) and no JAX device mesh; its other host
    C++ comes from the cache that the JAX child fills."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_poseidon, "available", lambda: False)
        mp.setattr(jax_sharding, "_PROVER_MESH", None)
        yield


def jax_cache_base() -> str:
    step = jax_pcy.CycleNovaProver(rc=1).step_func()
    return jax_params_cache.shape_cache_key(JAX_BN256.name, 1, step) + \
        hashlib.sha256(repr(()).encode()).hexdigest()[:8]


def cache_jax_secondary_shape() -> None:
    """The JAX secondary shape of the Nova cycle at rc = 1, synthesized
    here as ``CyclePublicParams.setup`` does and saved under the key
    that ``cycle_public_params`` gives it, so that the JAX child, which
    synthesizes its primary shape meanwhile, loads it."""
    curve1 = JAX_CURVES[JAX_BN256.name]

    def synth():
        cfg = jax_aug.AugmentedCfg(curve_other=curve1,
                                   p_other=JAX_BN256.modulus, io_arity=0,
                                   fold_at_base=True)
        w = jax_aug.AugmentedWitness(0, 0, 0, 0, [], [],
                                     jax_nova_cycle._default_relaxed(),
                                     None, [0, 0], None)
        cs = JaxCS(curve1.base)
        jax_aug.synthesize_augmented(cs, cfg, w)
        return jax_nova.R1CSShape(cs)
    jax_params_cache.cached_shape(f"{jax_cache_base()}_cyc2", curve1.base,
                                  synth)


def rel(u):
    return (u.comm_w, u.comm_e, list(u.x), u.u)


def plain(proof) -> dict:
    """A proof of either package as plain ints and tuples."""
    wit = lambda w: (list(w.w), list(w.e))                # noqa: E731
    return dict(n=proof.n, z0=list(proof.z0), zn=list(proof.zn),
                u1=rel(proof.u1), w1=wit(proof.w1), u2=rel(proof.u2),
                u2_pending=(proof.u2_pending.comm_w,
                            list(proof.u2_pending.x)),
                comm_t_last=proof.comm_t_last,
                w2_folded=wit(proof.w2_folded))


def to_jax(d: dict) -> "jax_nova_cycle.CycleProof":
    jrel = lambda u: jax_nova.RelaxedInstance(u[0], u[1], list(u[2]), u[3])  # noqa: E731,E501
    wit = lambda w: jax_nova.RelaxedWitness(list(w[0]), list(w[1]))  # noqa: E731,E501
    return jax_nova_cycle.CycleProof(
        d["n"], list(d["z0"]), list(d["zn"]), jrel(d["u1"]), wit(d["w1"]),
        jrel(d["u2"]), jax_nova.R1CSInstance(d["u2_pending"][0],
                                             list(d["u2_pending"][1])),
        d["comm_t_last"], wit(d["w2_folded"]))


def to_port(d: dict, pp) -> "nova_cycle.CycleProof":
    prel = lambda u: nova.RelaxedInstance(u[0], u[1], list(u[2]), u[3])  # noqa: E731,E501

    def wit(w, p):
        return nova.RelaxedWitness(PackedVec.pack(list(w[0]), p),
                                   PackedVec.pack(list(w[1]), p))
    return nova_cycle.CycleProof(
        d["n"], list(d["z0"]), list(d["zn"]), prel(d["u1"]),
        wit(d["w1"], P1), prel(d["u2"]),
        nova.R1CSInstance(d["u2_pending"][0], list(d["u2_pending"][1])),
        d["comm_t_last"], wit(d["w2_folded"], pp.field2.modulus))


def compressed_to_jax(cp) -> "jax_pcy.CompressedCycleProof":
    jrel = lambda u: jax_nova.RelaxedInstance(u.comm_w, u.comm_e,  # noqa
                                              list(u.x), u.u)
    return jax_pcy.CompressedCycleProof(
        cp.n, list(cp.z0), list(cp.zn), jrel(cp.u1), jrel(cp.u2),
        jax_nova.R1CSInstance(cp.u2_pending.comm_w, list(cp.u2_pending.x)),
        cp.comm_t_last, spartan_to_jax(cp.spartan1),
        spartan_to_jax(cp.spartan2))


@pytest.fixture(scope="module")
def proofs(jax_paths, tmp_path_factory):
    """The port's proof (through its fork pool: 3 chunks) and its
    compressed form, the JAX child's proof, and both packages' public
    parameters."""
    out = tmp_path_factory.mktemp("jax_nova_cycle") / "proof.pkl"
    child = subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(out), PROGRAM], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"})
    try:
        cache_jax_secondary_shape()
        native.build_host()
        store = Store(BN256_SCALAR, device="cpu")
        prover = pcy.CycleNovaProver(rc=1, device="cpu")
        pp, proof, frames = prover.evaluate_and_prove(
            store, read_with_default_state(store, PROGRAM), limit=50)
        # the compress's host C++ releases the interpreter lock: the JAX
        # public parameters are read here meanwhile
        with ThreadPoolExecutor(max_workers=1) as ex:
            compressing = ex.submit(pcy.compress_cycle, pp, proof)
            assert child.wait() == 0
            jstore = JaxStore(JAX_BN256, use_device=False)
            jpp = jax_pcy.cycle_public_params(
                jstore, 1, jax_pcy.CycleNovaProver(rc=1).step_func(), None)
            cp = compressing.result()
    finally:
        child.wait()
    with open(out, "rb") as f:
        jproof = pickle.load(f)
    assert store.fetch_num(frames[-1].output[0]) == 3
    return dict(pp=pp, proof=proof, cp=cp, store=store, frames=frames,
                prover=prover, jpp=jpp, jproof=jproof)


def test_cycle_proof_matches_jax(proofs):
    pp, proof, jproof = proofs["pp"], proofs["proof"], proofs["jproof"]
    assert proof.n == 3
    assert pp.pp_digest == jproof["pp_digest"] == proofs["jpp"].pp_digest
    assert [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for s in (pp.shape1, pp.shape2)] == jproof["shapes"]
    assert (pp.shape1.num_constraints, pp.shape1.num_aux,
            pp.shape2.num_constraints, pp.shape2.num_aux) == \
        (32537, 29296, 18303, 17014)
    assert (len(pp.ck1.gens), len(pp.ck2.gens)) == jproof["gens"] == \
        (1 << 15, 1 << 15)
    got = plain(proof)
    for field in ("n", "z0", "zn", "u1", "w1", "u2", "u2_pending",
                  "comm_t_last", "w2_folded"):
        assert got[field] == jproof[field], field


def test_verifiers_accept_each_others_proofs(proofs):
    pp, jpp = proofs["pp"], proofs["jpp"]
    assert jax_pcy.CycleNovaProver.verify(jpp, to_jax(plain(proofs["proof"])))
    assert pcy.CycleNovaProver.verify(pp, to_port(proofs["jproof"], pp))


@pytest.mark.parametrize("change", ["zn", "w2_folded"])
def test_verifiers_reject_a_changed_proof(proofs, change):
    pp, jpp = proofs["pp"], proofs["jpp"]
    bad = plain(proofs["proof"])
    if change == "zn":
        bad["zn"][1] = (bad["zn"][1] + 1) % P1
    else:
        w, e = bad["w2_folded"]
        w[5] = (w[5] + 1) % pp.field2.modulus
    assert not pcy.CycleNovaProver.verify(pp, to_port(bad, pp))
    assert not jax_pcy.CycleNovaProver.verify(jpp, to_jax(bad))


def test_compressed_proof_accepted_by_both(proofs):
    pp, cp, jpp = proofs["pp"], proofs["cp"], proofs["jpp"]
    assert cp.n == 3
    assert pcy.verify_compressed_cycle(pp, cp)
    assert jax_pcy.verify_compressed_cycle(jpp, compressed_to_jax(cp))


def test_compressed_proof_with_a_changed_zn_rejected_by_both(proofs):
    pp, cp, jpp = proofs["pp"], proofs["cp"], proofs["jpp"]
    zn = list(cp.zn)
    zn[1] = (zn[1] + 1) % P1
    bad = dataclasses.replace(cp, zn=zn)
    assert not pcy.verify_compressed_cycle(pp, bad)
    assert not jax_pcy.verify_compressed_cycle(jpp, compressed_to_jax(bad))


def test_pool_witnesses_equal_inline(proofs):
    """The shared fork pool's (aux segment, z_next) of every step equals
    the same synthesis run here."""
    pp, store, prover = proofs["pp"], proofs["store"], proofs["prover"]
    mframes = MultiFrame.from_frames(proofs["frames"], 1,
                                     prover.step_func(), store)
    jobs = prover.witness_jobs(store, mframes)
    assert len(jobs) == 3 and witness_pool.uses_pool(False, len(jobs))
    pooled = list(witness_pool.step_witnesses(store, pp.cfg1.step_fn, jobs,
                                              check_steps=False))
    for (seg, outs), (z_in, aux), mf in zip(pooled, jobs, mframes):
        packed, outs_inline = witness_pool.step_witness(
            pp.field1, pp.cfg1.step_fn, z_in, aux)
        assert seg == witness_pool.unpack_segment(packed)
        assert outs == outs_inline == mf.z_out
        assert len(seg) > 1000
    assert witness_pool._POOL_ARGS is None
