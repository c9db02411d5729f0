"""The port's NIVC backend (``lurk_tpu_torch.proof.supernova``:
``SuperNovaProver``, ``verify``, ``compress``, ``verify_compressed``)
against the JAX package on the CPU. Integers only: tolerance 0.

- ``SuperNovaProver(rc=1, lang=Lang(), device="cpu")`` proves
  ``(* 6 7)`` into the JAX ``SuperNovaProver``'s proof, field by field:
  the steps (circuit index, instance, cross-term commitment), the final
  witnesses, ``z0``, ``zi``, and the ``"-nivc"`` shape's digest.
- Each package's verifier accepts the other's proof; both reject it
  after one final witness entry is changed.
- The JAX ``verify_compressed`` accepts the port's compressed proof, as
  the port's does; both reject it after a changed step input and with
  no Spartan proofs.
- A coprocessor with no circuit makes the prove raise
  ``SynthesisError``.

The JAX side proves in a child process (its host C++ built into
``$LURK_TPU_CACHE`` in grandchildren meanwhile) while the port proves
and compresses here; this process then reads the JAX shape the child
cached.
"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.parallel.sharding as jax_sharding
import lurk_tpu.proof.nova as jax_nova
import lurk_tpu.proof.params_cache as jax_params_cache
import lurk_tpu.proof.supernova as jax_sn
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem.evaluation import Lang as JaxLang
from lurk_tpu_torch import native
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.lem.evaluation import Coprocessor, Lang
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import nova
from lurk_tpu_torch.proof import supernova as sn
from lurk_tpu_torch.r1cs.cs import SynthesisError
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import Symbol
from test_torch_compress import spartan_to_jax
from test_torch_field import one_torch_thread  # noqa: F401

PROGRAM = "(* 6 7)"
ROOT = pathlib.Path(__file__).resolve().parent.parent
P = BN256_SCALAR.modulus

# The JAX side, run as a child process: its host libraries (msm, srs,
# r1cs, spartan) compile in grandchildren while it evaluates
# and synthesizes, and each load waits for its build; its Poseidon runs
# its Python path. SuperNovaProver(rc=1, Lang()) proves the program and
# the proof is written out as plain ints and tuples.
JAX_CHILD = r'''
import pickle, subprocess, sys
import lurk_tpu.native as native
builds = {n: subprocess.Popen([sys.executable, "-c",
                               "from lurk_tpu import native; "
                               f"assert native.load({n!r}) is not None"])
          for n in ("msm", "srs", "r1cs", "spartan")}
load = native.load
def load_when_built(name):
    if name in builds and builds.pop(name).wait() != 0:
        raise RuntimeError(f"JAX host library {name} did not build")
    return load(name)
native.load = load_when_built
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.lem.evaluation import Lang
from lurk_tpu.parser import read_with_default_state
from lurk_tpu.proof.supernova import SuperNovaProver
from lurk_tpu.store.core import Store
store = Store(BN256_SCALAR, use_device=False)
pp, proof, frames = SuperNovaProver(rc=1, lang=Lang()).evaluate_and_prove(
    store, read_with_default_state(store, sys.argv[2]), limit=50)
assert all(b.wait() == 0 for b in builds.values())
s = pp.shapes[0]
out = dict(shape=(s.digest, s.num_inputs, s.num_aux, s.num_constraints),
           gens=len(pp.ck.gens),
           steps=[(pc, inst.comm_w, list(inst.x), comm_t)
                  for pc, inst, comm_t in proof.steps],
           final_witnesses={pc: (list(w.w), list(w.e))
                            for pc, w in proof.final_witnesses.items()},
           z0=proof.z0, zi=proof.zi)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def plain(proof) -> dict:
    """A proof of either package as plain ints and tuples."""
    return dict(steps=[(pc, inst.comm_w, list(inst.x), comm_t)
                       for pc, inst, comm_t in proof.steps],
                final_witnesses={pc: (list(w.w), list(w.e))
                                 for pc, w in proof.final_witnesses.items()},
                z0=list(proof.z0), zi=list(proof.zi))


def to_jax(d: dict) -> "jax_sn.NivcProof":
    return jax_sn.NivcProof(
        [(pc, jax_nova.R1CSInstance(w, list(x)), t)
         for pc, w, x, t in d["steps"]],
        {pc: jax_nova.RelaxedWitness(list(w), list(e))
         for pc, (w, e) in d["final_witnesses"].items()},
        list(d["z0"]), list(d["zi"]))


def to_port(d: dict) -> "sn.NivcProof":
    return sn.NivcProof(
        [(pc, nova.R1CSInstance(w, list(x)), t)
         for pc, w, x, t in d["steps"]],
        {pc: nova.RelaxedWitness(PackedVec.pack(list(w), P),
                                 PackedVec.pack(list(e), P))
         for pc, (w, e) in d["final_witnesses"].items()},
        list(d["z0"]), list(d["zi"]))


def compressed_to_jax(cp) -> "jax_sn.CompressedNivcProof":
    return jax_sn.CompressedNivcProof(
        [(pc, jax_nova.R1CSInstance(inst.comm_w, list(inst.x)), comm_t)
         for pc, inst, comm_t in cp.steps],
        {pc: spartan_to_jax(sp) for pc, sp in cp.spartans.items()},
        list(cp.z0), list(cp.zi))


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """The port's proof and its compressed form, the JAX child's proof,
    and both packages' public parameters."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    out = tmp_path_factory.mktemp("jax_nivc") / "proof.pkl"
    child = subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(out), PROGRAM], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"})
    try:
        native.build_host()
        store = Store(BN256_SCALAR, device="cpu")
        prover = sn.SuperNovaProver(rc=1, lang=Lang(), device="cpu")
        pp, proof, frames = prover.evaluate_and_prove(
            store, read_with_default_state(store, PROGRAM), limit=50)
        cp = sn.compress(pp, proof)
    finally:
        assert child.wait() == 0
    with open(out, "rb") as f:
        jproof = pickle.load(f)
    assert store.fetch_num(frames[-1].output[0]) == 42
    jprover = jax_sn.SuperNovaProver(rc=1, lang=JaxLang())
    key = jax_params_cache.shape_cache_key(JAX_BN256.name, 1,
                                           jprover.lurk_step) + "-nivc"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_poseidon, "available", lambda: False)
        mp.setattr(jax_sharding, "_PROVER_MESH", None)
        jpp = jax_sn.SuperNovaPublicParams.setup(
            {0: jax_params_cache.load_shape(key, JAX_BN256)})
        yield dict(pp=pp, proof=proof, cp=cp, jpp=jpp, jproof=jproof)


def test_nivc_proof_matches_jax(proofs):
    pp, proof, jproof = proofs["pp"], proofs["proof"], proofs["jproof"]
    s = pp.shapes[0]
    assert list(pp.shapes) == [0] and len(proof.steps) == 3
    assert (s.digest, s.num_inputs, s.num_aux, s.num_constraints) == \
        jproof["shape"]
    assert proofs["jpp"].shapes[0].digest == s.digest
    # the SRS of 2^14 powers or a longer one already in memory
    assert min(len(pp.ck.gens), jproof["gens"]) >= 1 << 14
    got = plain(proof)
    for field in ("steps", "final_witnesses", "z0", "zi"):
        assert got[field] == jproof[field], field


def test_verifiers_accept_each_others_proofs(proofs):
    assert jax_sn.verify(proofs["jpp"], to_jax(plain(proofs["proof"])))
    assert sn.verify(proofs["pp"], to_port(proofs["jproof"]))


def test_verifiers_reject_a_changed_final_witness(proofs):
    bad = plain(proofs["proof"])
    w, e = bad["final_witnesses"][0]
    w[9] = (w[9] + 1) % P
    assert not sn.verify(proofs["pp"], to_port(bad))
    assert not jax_sn.verify(proofs["jpp"], to_jax(bad))


def test_compressed_proof_accepted_by_both(proofs):
    cp = proofs["cp"]
    assert list(cp.spartans) == [0]
    assert sn.verify_compressed(proofs["pp"], cp)
    assert jax_sn.verify_compressed(proofs["jpp"], compressed_to_jax(cp))


@pytest.mark.parametrize("change", ["step input", "no spartans"])
def test_changed_compressed_proof_rejected_by_both(proofs, change):
    cp = proofs["cp"]
    if change == "step input":
        pc, inst, comm_t = cp.steps[0]
        x = list(inst.x)
        x[0] = (x[0] + 1) % P
        steps = [(pc, nova.R1CSInstance(inst.comm_w, x), comm_t)]
        bad = dataclasses.replace(cp, steps=steps + cp.steps[1:])
    else:
        bad = dataclasses.replace(cp, spartans={})
    assert not sn.verify_compressed(proofs["pp"], bad)
    assert not jax_sn.verify_compressed(proofs["jpp"], compressed_to_jax(bad))


def test_a_coprocessor_without_a_circuit_is_not_provable():
    """A coprocessor step whose coprocessor has no circuit: the prove
    raises ``SynthesisError`` and binds no unconstrained advice."""
    lang = Lang()
    sym = Symbol.sym(["cproc", "dumb"])
    lang.add_coprocessor(sym, Coprocessor(0, lambda store, args:
                                          store.num(42)))
    store = Store(BN256_SCALAR, device="cpu")
    prover = sn.SuperNovaProver(rc=1, lang=lang, device="cpu")
    with pytest.raises(SynthesisError, match="no circuit synthesizer"):
        prover.evaluate_and_prove(store, store.list([store.intern_symbol(
            sym)]), limit=50)
