"""The port's SuperNova cycle fold (``lurk_tpu_torch.proof.
{supernova,nova_cycle,supernova_cycle,prover_supernova_cycle}``) against
the JAX package on the CPU. Integers only: tolerance 0.

- ``SuperNovaCycleProver(rc=1, device="cpu")`` proves ``(+ 1 2)`` (3
  frames, so 3 steps: the shortest length at which the fork pool of
  step witnesses runs) into the JAX ``SuperNovaCycleProver``'s proof,
  field by field: ``pp_digest``, the shape digests and counts, ``u1s``,
  ``w1s``, ``u2``, ``u2_pending``, ``comm_t_last`` and ``w2_folded``.
- Each package's verifier accepts the other's proof; both reject a
  changed ``zn`` and a changed entry of ``w2_folded``.
- The shared fork pool's step witnesses (:mod:`witness_pool`) equal
  the inline ones, and a worker's exception fails the prove.
- The shape files are read back by both packages.

The JAX side proves in a child process, with its host C++ (built into
``$LURK_TPU_CACHE``, one g++ per library, all at once), while this
process synthesizes the JAX secondary shape for it and then the port
proves; this process then builds the JAX public parameters from the
shapes and keys that the child cached.
"""

import hashlib
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.parallel.sharding as jax_sharding
import lurk_tpu.proof.hyperkzg as jax_hyperkzg
import lurk_tpu.proof.nova as jax_nova
import lurk_tpu.proof.nova_cycle as jax_nova_cycle
import lurk_tpu.proof.params_cache as jax_params_cache
import lurk_tpu.proof.prover_supernova_cycle as jax_psc
import lurk_tpu.proof.supernova_augmented as jax_sa
import lurk_tpu.proof.supernova_cycle as jax_sc
from lurk_tpu.curves.weierstrass import CURVE_FOR_FIELD as JAX_CURVES
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.r1cs.cs import ConstraintSystem as JaxCS
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch import native
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.lem.evaluation import Coprocessor, Lang
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import hyperkzg, nova, params_cache, witness_pool
from lurk_tpu_torch.proof import prover_supernova_cycle as psc
from lurk_tpu_torch.proof import supernova_cycle as sc
from lurk_tpu_torch.r1cs.cs import SynthesisError
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import Symbol
from test_torch_field import one_torch_thread  # noqa: F401

PROGRAM = "(+ 1 2)"
ROOT = pathlib.Path(__file__).resolve().parent.parent
P1 = BN256_SCALAR.modulus

# The JAX side, run as a child process: the JAX host libraries that its
# fold uses (msm, srs, pedersen, r1cs) compile in grandchildren while it
# synthesizes its shapes, and each load waits for its build; its
# Poseidon runs its Python path (its C++ takes longer to compile than
# the whole prove). SuperNovaCycleProver(rc=1) then proves the program
# (no fork pool: the suite sets LURK_TPU_PERF=parallel-steps-only), and
# the proof is written out as plain ints and tuples. The libraries stay
# in $LURK_TPU_CACHE for this process.
JAX_CHILD = r'''
import pickle, subprocess, sys
import lurk_tpu.native as native
builds = {n: subprocess.Popen([sys.executable, "-c",
                               "from lurk_tpu import native; "
                               f"assert native.load({n!r}) is not None"])
          for n in ("msm", "srs", "pedersen", "r1cs")}
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
from lurk_tpu.proof.prover_supernova_cycle import SuperNovaCycleProver
from lurk_tpu.store.core import Store
store = Store(BN256_SCALAR, use_device=False)
pp, proof, frames = SuperNovaCycleProver(rc=1).evaluate_and_prove(
    store, read_with_default_state(store, sys.argv[2]), limit=50)
assert all(b.wait() == 0 for b in builds.values())
rel = lambda u: (u.comm_w, u.comm_e, list(u.x), u.u)
wit = lambda w: (list(w.w), list(w.e))
shapes = [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
          for s in pp.shapes1 + [pp.shape2]]
out = dict(pp_digest=pp.pp_digest, shapes=shapes,
           gens=(len(pp.ck1.gens), len(pp.ck2.gens)), n=proof.n,
           z0=proof.z0, zn=proof.zn, pc_n=proof.pc_n,
           u1s=[rel(u) for u in proof.u1s], w1s=[wit(w) for w in proof.w1s],
           u2=rel(proof.u2),
           u2_pending=(proof.u2_pending.comm_w, list(proof.u2_pending.x)),
           comm_t_last=proof.comm_t_last, w2_folded=wit(proof.w2_folded))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def start_jax_child(out_path, program: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(out_path), program],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                       "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def jax_paths(tmp_path_factory):
    """The suite's parameter cache, the JAX package's Python Poseidon
    (its C++ is not compiled here) and no JAX device mesh; its other host
    C++ comes from the cache that the JAX child fills. Both packages'
    SRS and cycle public parameters start empty in memory: a key takes
    the length of the SRS already there, which another module of the
    same process may have grown."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_poseidon, "available", lambda: False)
        mp.setattr(jax_sharding, "_PROVER_MESH", None)
        for mod in (jax_hyperkzg, hyperkzg):
            mp.setattr(mod, "_SRS_MEM", {})
        for mod in (jax_psc, psc):
            mp.setattr(mod, "_PP_CACHE", {})
        yield


def cache_jax_secondary_shape() -> None:
    """The JAX secondary shape of the cycle at rc = 1, synthesized here
    as ``SnCyclePublicParams.setup`` does and saved under the key that
    ``sn_cycle_public_params`` gives it, so that the JAX child, which
    synthesizes its primary shape meanwhile, loads it."""
    step, _ = jax_psc.SuperNovaCycleProver(rc=1).setup_funcs()
    base = jax_params_cache.shape_cache_key(JAX_BN256.name, 1, step) + \
        hashlib.sha256(repr(()).encode()).hexdigest()[:8]
    curve1 = JAX_CURVES[JAX_BN256.name]

    def synth():
        cfg = jax_sa.SnSecondaryCfg(curve_other=curve1,
                                    p_other=JAX_BN256.modulus, n_circuits=1)
        w = jax_sa.SnSecondaryWitness(0, 0, 0, 0, 0,
                                      [jax_nova_cycle._default_relaxed()],
                                      None, [0, 0], None)
        cs = JaxCS(curve1.base)
        jax_sa.synthesize_sn_secondary(cs, cfg, w)
        return jax_nova.R1CSShape(cs)
    jax_params_cache.cached_shape(f"{base}_snsec_1", curve1.base, synth)


def jax_public_params():
    """The JAX package's cycle public parameters at rc = 1, from the
    shapes and keys in its cache."""
    jstore = JaxStore(JAX_BN256, use_device=False)
    prover = jax_psc.SuperNovaCycleProver(rc=1)
    step, cprocs = prover.setup_funcs()
    return jax_psc.sn_cycle_public_params(jstore, 1, step, cprocs, None)


def plain(proof) -> dict:
    """A proof of either package as plain ints and tuples."""
    rel = lambda u: (u.comm_w, u.comm_e, list(u.x), u.u)  # noqa: E731
    wit = lambda w: (list(w.w), list(w.e))                # noqa: E731
    return dict(n=proof.n, z0=list(proof.z0), zn=list(proof.zn),
                pc_n=proof.pc_n, u1s=[rel(u) for u in proof.u1s],
                w1s=[wit(w) for w in proof.w1s], u2=rel(proof.u2),
                u2_pending=(proof.u2_pending.comm_w,
                            list(proof.u2_pending.x)),
                comm_t_last=proof.comm_t_last,
                w2_folded=wit(proof.w2_folded))


def to_jax(d: dict) -> "jax_sc.SnCycleProof":
    rel = lambda u: jax_nova.RelaxedInstance(u[0], u[1], list(u[2]), u[3])  # noqa: E731,E501
    wit = lambda w: jax_nova.RelaxedWitness(list(w[0]), list(w[1]))  # noqa: E731,E501
    return jax_sc.SnCycleProof(
        d["n"], list(d["z0"]), list(d["zn"]), d["pc_n"],
        [rel(u) for u in d["u1s"]], [wit(w) for w in d["w1s"]],
        rel(d["u2"]), jax_nova.R1CSInstance(d["u2_pending"][0],
                                            list(d["u2_pending"][1])),
        d["comm_t_last"], wit(d["w2_folded"]))


def to_port(d: dict, pp) -> "sc.SnCycleProof":
    rel = lambda u: nova.RelaxedInstance(u[0], u[1], list(u[2]), u[3])  # noqa: E731,E501

    def wit(w, p):
        return nova.RelaxedWitness(PackedVec.pack(list(w[0]), p),
                                   PackedVec.pack(list(w[1]), p))
    p2 = pp.field2.modulus
    return sc.SnCycleProof(
        d["n"], list(d["z0"]), list(d["zn"]), d["pc_n"],
        [rel(u) for u in d["u1s"]], [wit(w, P1) for w in d["w1s"]],
        rel(d["u2"]), nova.R1CSInstance(d["u2_pending"][0],
                                        list(d["u2_pending"][1])),
        d["comm_t_last"], wit(d["w2_folded"], p2))


@pytest.fixture(scope="module")
def proofs(jax_paths, tmp_path_factory):
    """The port's proof (through its fork pool: 3 chunks), the JAX
    child's, and both packages' public parameters."""
    out = tmp_path_factory.mktemp("jax_sn_cycle") / "proof.pkl"
    child = start_jax_child(out, PROGRAM)
    try:
        cache_jax_secondary_shape()
        native.build_host()
        store = Store(BN256_SCALAR, device="cpu")
        prover = psc.SuperNovaCycleProver(rc=1, device="cpu")
        frames_expr = read_with_default_state(store, PROGRAM)
        pp, proof, frames = prover.evaluate_and_prove(store, frames_expr,
                                                      limit=50)
    finally:
        assert child.wait() == 0
    with open(out, "rb") as f:
        jproof = pickle.load(f)
    assert store.fetch_num(frames[-1].output[0]) == 3
    return dict(pp=pp, proof=proof, store=store, frames=frames,
                prover=prover, jpp=jax_public_params(), jproof=jproof)


def test_cycle_proof_matches_jax(proofs):
    pp, proof, jproof = proofs["pp"], proofs["proof"], proofs["jproof"]
    assert proof.n == 3 and pp.n_circuits == 1
    assert pp.pp_digest == jproof["pp_digest"]
    assert [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for s in pp.shapes1 + [pp.shape2]] == jproof["shapes"]
    assert (pp.shapes1[0].num_constraints, pp.shapes1[0].num_aux,
            pp.shape2.num_constraints, pp.shape2.num_aux) == \
        (32538, 29298, 18324, 17034)
    assert (len(pp.ck1.gens), len(pp.ck2.gens)) == jproof["gens"] == \
        (1 << 15, 1 << 15)
    got = plain(proof)
    for field in ("n", "z0", "zn", "pc_n", "u1s", "w1s", "u2",
                  "u2_pending", "comm_t_last", "w2_folded"):
        assert got[field] == jproof[field], field
    assert proofs["jpp"].pp_digest == pp.pp_digest


def test_verifiers_accept_each_others_proofs(proofs):
    pp, jpp = proofs["pp"], proofs["jpp"]
    assert jax_psc.SuperNovaCycleProver.verify(jpp,
                                               to_jax(plain(proofs["proof"])))
    assert psc.SuperNovaCycleProver.verify(pp, to_port(proofs["jproof"], pp))


@pytest.mark.parametrize("change", ["zn", "w2_folded"])
def test_verifiers_reject_a_changed_proof(proofs, change):
    pp, jpp = proofs["pp"], proofs["jpp"]
    bad = plain(proofs["proof"])
    if change == "zn":
        bad["zn"][1] = (bad["zn"][1] + 1) % P1
    else:
        w, e = bad["w2_folded"]
        w[5] = (w[5] + 1) % pp.field2.modulus
    assert not psc.SuperNovaCycleProver.verify(pp, to_port(bad, pp))
    assert not jax_psc.SuperNovaCycleProver.verify(jpp, to_jax(bad))


def test_pool_witnesses_equal_inline(proofs):
    """The shared fork pool's (aux segment, (z_next, pc_next)) of every
    step equals the same synthesis run here."""
    pp, store, prover = proofs["pp"], proofs["store"], proofs["prover"]
    padded = prover.chunks(store, proofs["frames"])
    jobs = prover.witness_jobs(store, padded)
    assert len(padded) == 3 and witness_pool.uses_pool(prover.check_steps,
                                                       len(padded))
    step_fn = pp.cfg1s[0].step_fn
    pooled = list(witness_pool.step_witnesses(store, step_fn, jobs,
                                              prover.check_steps))
    for (seg, (outs, pc_next)), (z_in, aux) in zip(pooled, jobs):
        packed, (outs_inline, pc_inline) = witness_pool.step_witness(
            pp.field1, step_fn, z_in, aux)
        assert seg == witness_pool.unpack_segment(packed)
        assert (outs, pc_next) == (outs_inline, pc_inline)
        assert len(seg) > 1000
    assert witness_pool._POOL_ARGS is None


def _failing_worker(k):
    raise RuntimeError(f"worker failed on step {k}")


def test_a_worker_exception_fails_the_prove(proofs, monkeypatch):
    monkeypatch.setattr(witness_pool, "_worker", _failing_worker)
    with pytest.raises(RuntimeError, match="worker failed on step 0"):
        proofs["prover"].prove_from_frames(proofs["store"],
                                           proofs["frames"])


def test_shape_files_read_back_by_both_packages(proofs, monkeypatch):
    """The port's cached shapes load in the JAX package, and the JAX
    child's in the port, under the same keys."""
    pp, jpp = proofs["pp"], proofs["jpp"]
    step, _ = proofs["prover"].setup_funcs()
    jstep, _ = jax_psc.SuperNovaCycleProver(rc=1).setup_funcs()
    base = params_cache.shape_cache_key("bn256", 1, step)
    assert base == jax_params_cache.shape_cache_key("bn256", 1, jstep)
    base += hashlib.sha256(repr(()).encode()).hexdigest()[:8]
    port_dir, jax_dir = params_cache.cache_dir(), jax_params_cache.cache_dir()
    names = [f"shape-{base}_sn0.npz", f"shape-{base}_snsec_1.npz"]
    for d in (port_dir, jax_dir):
        assert all((d / name).exists() for name in names)
    want = {(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for s in pp.shapes1 + [pp.shape2]}
    for name in names:
        key = name[len("shape-"):-len(".npz")]
        secondary = "_snsec_" in key
        field = pp.field2 if secondary else BN256_SCALAR
        jfield = jpp.field2 if secondary else JAX_BN256
        got = set()
        for d in (port_dir, jax_dir):
            monkeypatch.setattr(params_cache, "cache_dir", lambda d=d: d)
            monkeypatch.setattr(jax_params_cache, "cache_dir",
                                lambda d=d: d)
            for shape in (params_cache.load_shape(key, field),
                          jax_params_cache.load_shape(key, jfield)):
                got.add((shape.digest, shape.num_inputs, shape.num_aux,
                         shape.num_constraints))
        assert len(got) == 1 and got <= want


def test_a_coprocessor_without_a_circuit_is_not_provable():
    """The public parameters of a ``Lang`` whose coprocessor has no
    circuit: synthesizing that circuit's shape raises
    ``SynthesisError``."""
    lang = Lang()
    sym = Symbol.sym(["cproc", "dumb"])
    lang.add_coprocessor(sym, Coprocessor(0, lambda store, args:
                                          store.num(42)))
    store = Store(BN256_SCALAR, device="cpu")
    prover = psc.SuperNovaCycleProver(rc=1, lang=lang, device="cpu")
    with pytest.raises(SynthesisError, match="no circuit synthesizer"):
        prover.evaluate_and_prove(store, store.list([store.intern_symbol(
            sym)]), limit=50)
