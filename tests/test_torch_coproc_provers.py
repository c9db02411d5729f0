"""Every prover of the port with coprocessors, against the JAX package on
the CPU. Integers only: tolerance 0.

- ``SuperNovaCycleProver(rc=1)`` with the ``sha256_1`` coprocessor
  proves ``(sha256_1 7)`` (4 frames, pcs [0, 0, 1, 0]: 4 steps over two
  primary circuits, through the fork pool) into the JAX prover's proof,
  field by field; each verifier accepts the other's proof; the JAX
  ``verify_compressed_sn_cycle`` accepts the port's ``compress_sn_cycle``
  (two primary Spartan proofs), as the port's does.
- ``SuperNovaProver(rc=1)`` proves ``(+ 1 (sha256_1 7))`` into the JAX
  prover's proof, field by field (the shapes of both circuits included),
  each verifier accepting the other's; its proof file is verified by the
  port's ``Repl.verify_proof_key`` and the JAX ``Repl``'s, each with the
  sha256 ``Lang`` set (circuit 1's shape from its blank frame).
- ``CycleNovaProver(rc=1)`` and ``NovaProver(rc=1)`` with sha256 inlined
  in the step (IVC) each prove and verify ``(sha256_1 7)``; the IVC
  step's shape digest equals the JAX one.
- The trie program ``(.lurk.trie.lookup (.lurk.trie.insert
  (.lurk.trie.new) 1 2) 1)`` (12 frames over all 4 circuits) through
  ``SuperNovaCycleProver(rc=1)`` and its fork pool, verified by the port;
  a changed final z is rejected.
- A coprocessor with no circuit makes every prover raise
  ``SynthesisError``.

The JAX side proves in two child processes (its host C++ built into
``$LURK_TPU_CACHE`` in threads of the first meanwhile, its Poseidon on
its Python path). The port's IVC provers and its trie prove run in two more
children; this process proves the port's cycle and NIVC proofs
meanwhile (the compression in a thread beside the NIVC prove), then
holds them against the JAX children's.
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

from lurk_tpu_torch import native
from lurk_tpu_torch.cli.lurk_proof import LurkProof
from lurk_tpu_torch.cli.repl import Repl
from lurk_tpu_torch.coproc.sha256 import sha256_coprocessor
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem.evaluation import Coprocessor, Lang
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import hyperkzg, params_cache, prover
from lurk_tpu_torch.proof import prover_cycle
from lurk_tpu_torch.proof import prover_supernova_cycle as psc
from lurk_tpu_torch.proof import supernova as sn
from lurk_tpu_torch.r1cs.cs import SynthesisError
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import user_sym
from test_torch_compress import compressed_to_jax as sn_cycle_compressed_to_jax
from test_torch_field import one_torch_thread  # noqa: F401
import test_torch_nivc as nivc_io
import test_torch_supernova_cycle as cycle_io

ROOT = pathlib.Path(__file__).resolve().parent.parent
P1 = BN256_SCALAR.modulus
CYCLE_PROGRAM = "(sha256_1 7)"
NIVC_PROGRAM = "(+ 1 (sha256_1 7))"
TRIE_PROGRAM = \
    "(.lurk.trie.lookup (.lurk.trie.insert (.lurk.trie.new) 1 2) 1)"


def sha256_lang() -> Lang:
    lang = Lang()
    lang.add_coprocessor(user_sym("sha256_1"), sha256_coprocessor(1))
    return lang


# The JAX side, two children: "cycle" builds the JAX host libraries in
# threads while it evaluates and synthesizes, proves the cycle
# program, then verifies the port's cycle proof and compressed proof
# (the JAX objects the parent pickles into "port-cycle"); "nivc"
# synthesizes the IVC step with sha256 inlined, proves the NIVC
# program, then verifies the port's NIVC proof file (its key in
# "port-nivc") through the JAX Repl. Each writes its results as plain
# ints and tuples.
JAX_CHILD = r'''
import contextlib, os, pickle, sys, threading, time
from concurrent.futures import ThreadPoolExecutor
import lurk_tpu.native as native
out_dir, which, program = sys.argv[1:4]
built = os.path.join(out_dir, "jax-libs-built")
load = native.load
if which == "cycle":
    # the libraries compile at once in threads (the loader's lock would
    # take them one at a time)
    native._LOAD_LOCK = contextlib.nullcontext()
    pool = ThreadPoolExecutor(5)
    builds = {n: pool.submit(load, n)
              for n in ("msm", "srs", "pedersen", "r1cs", "spartan")}
    def mark_built():
        if all(b.result() is not None for b in builds.values()):
            open(built, "w").close()
    threading.Thread(target=mark_built, daemon=True).start()
    def load_when_built(name):
        if name not in builds:
            return load(name)
        lib = builds[name].result()
        if lib is None:
            raise RuntimeError(f"JAX host library {name} did not build")
        return lib
else:
    # the "cycle" child builds the libraries: wait for them rather than
    # compile them a second time
    def load_when_built(name):
        for _ in range(12000):
            if os.path.exists(built):
                break
            time.sleep(0.05)
        return load(name)
native.load = load_when_built
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.coproc.sha256 import sha256_coprocessor
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.lem.eval_step import make_eval_step
from lurk_tpu.lem.evaluation import Lang, LangSetup, evaluate
from lurk_tpu.parser import read_with_default_state
from lurk_tpu.proof.multiframe import MultiFrame
from lurk_tpu.proof.prover_supernova_cycle import SuperNovaCycleProver
from lurk_tpu.proof.supernova import SuperNovaProver
from lurk_tpu.store.core import Store
from lurk_tpu.symbol import user_sym
def port_file(name):
    """The port's file ``name`` in out_dir, once the parent has written
    it."""
    path = os.path.join(out_dir, name)
    for _ in range(18000):
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        time.sleep(0.05)
    raise TimeoutError(path)
lang = Lang()
lang.add_coprocessor(user_sym("sha256_1"), sha256_coprocessor(1))
store = Store(BN256_SCALAR, use_device=False)
expr = read_with_default_state(store, program)
shape = lambda s: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
if which == "nivc":
    step = make_eval_step(tuple(lang.cproc_specs()), True)
    frames = evaluate(LangSetup.ivc(lang), read_with_default_state(
        store, sys.argv[4]), store, 50)
    mf = MultiFrame.from_frames(frames, 1, step, store, lang)[0]
    _, _, cs = mf.instance(step, store,
                           cproc_synthesizers=lang.circuit_synthesizers())
    pp, proof, frames = SuperNovaProver(rc=1, lang=lang).evaluate_and_prove(
        store, expr, limit=50)
    out = dict(shapes={pc: shape(s) for pc, s in pp.shapes.items()},
               gens=len(pp.ck.gens),
               steps=[(pc, inst.comm_w, list(inst.x), comm_t)
                      for pc, inst, comm_t in proof.steps],
               final_witnesses={pc: (list(w.w), list(w.e))
                                for pc, w in proof.final_witnesses.items()},
               z0=proof.z0, zi=proof.zi,
               ivc_shape=(cs.shape_digest(), cs.num_constraints, cs.num_aux))
    from lurk_tpu.cli.repl import Repl
    repl = Repl(store, rc=1, backend="supernova")
    repl.lang = lang
    out["repl_verified"] = repl.verify_proof_key(port_file("port-nivc"))
else:
    pp, proof, frames = SuperNovaCycleProver(rc=1, lang=lang) \
        .evaluate_and_prove(store, expr, limit=50)
    assert all(b.result() is not None for b in builds.values())
    rel = lambda u: (u.comm_w, u.comm_e, list(u.x), u.u)
    wit = lambda w: (list(w.w), list(w.e))
    out = dict(
        pp_digest=pp.pp_digest,
        shapes=[shape(s) for s in pp.shapes1 + [pp.shape2]],
        gens=(len(pp.ck1.gens), len(pp.ck2.gens)), n=proof.n,
        z0=proof.z0, zn=proof.zn, pc_n=proof.pc_n,
        u1s=[rel(u) for u in proof.u1s], w1s=[wit(w) for w in proof.w1s],
        u2=rel(proof.u2),
        u2_pending=(proof.u2_pending.comm_w, list(proof.u2_pending.x)),
        comm_t_last=proof.comm_t_last, w2_folded=wit(proof.w2_folded))
    from lurk_tpu.proof.prover_supernova_cycle import (
        verify_compressed_sn_cycle)
    port = port_file("port-cycle")
    out["verdicts"] = (SuperNovaCycleProver.verify(pp, port["proof"]),
                       verify_compressed_sn_cycle(pp, port["compressed"]),
                       verify_compressed_sn_cycle(pp, port["changed"]))
with open(os.path.join(out_dir, which), "wb") as f:
    pickle.dump(out, f)
'''

# The port's provers that no JAX proof is held against: "ivc" (the Nova
# cycle and the Nova IVC with sha256 inlined) and "trie" (the trie
# program through the SuperNova cycle and its fork pool).
PORT_CHILD = r'''
import dataclasses, os, pickle, sys
import torch
torch.set_num_threads(1)
from lurk_tpu_torch import native
from lurk_tpu_torch.coproc.sha256 import sha256_coprocessor
from lurk_tpu_torch.coproc.trie import install_trie_lang
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem.evaluation import Lang
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import prover, prover_cycle
from lurk_tpu_torch.proof import prover_supernova_cycle as psc
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import user_sym
out_dir, which, program = sys.argv[1:4]
native.build_host()
store = Store(BN256_SCALAR, device="cpu")
expr = read_with_default_state(store, program)
def changed_zn(proof):
    zn = list(proof.zn)
    zn[1] = (zn[1] + 1) % BN256_SCALAR.modulus
    return dataclasses.replace(proof, zn=zn)
if which == "ivc":
    lang = Lang()
    lang.add_coprocessor(user_sym("sha256_1"), sha256_coprocessor(1))
    cyc = prover_cycle.CycleNovaProver(rc=1, lang=lang, device="cpu")
    pp, proof, frames = cyc.evaluate_and_prove(store, expr, limit=50)
    out = dict(cycle=(proof.n, cyc.verify(pp, proof),
                      cyc.verify(pp, changed_zn(proof)),
                      store.fetch_num(frames[-1].output[0])))
    ivc = prover.NovaProver(rc=1, lang=lang, device="cpu")
    pp, proof, frames = ivc.evaluate_and_prove(store, expr, limit=50)
    s = pp.shape
    out["nova"] = (len(proof.steps), ivc.verify(pp, proof),
                   store.fetch_num(frames[-1].output[0]),
                   (s.digest, s.num_constraints, s.num_aux))
else:
    lang, *_ = install_trie_lang()
    cyc = psc.SuperNovaCycleProver(rc=1, lang=lang, device="cpu")
    pp, proof, frames = cyc.evaluate_and_prove(store, expr, limit=100)
    z = store.hash_ptr(frames[-1].output[0])
    out = dict(pcs=[f.pc for f in frames], n=proof.n, out=(z.tag, z.digest),
               counts=[(s.num_constraints, s.num_aux) for s in pp.shapes1],
               verified=cyc.verify(pp, proof),
               changed=cyc.verify(pp, changed_zn(proof)))
with open(os.path.join(out_dir, which), "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two JAX children and the port's two, started first; then the
    port's cycle proof and compressed proof and its NIVC proof and proof
    file, made here meanwhile and handed to the JAX children to
    verify."""
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    out = tmp_path_factory.mktemp("coproc_provers")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    children = {
        "jax-cycle": subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(out), "cycle",
             CYCLE_PROGRAM], cwd=ROOT, env=env),
        "jax-nivc": subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(out), "nivc",
             NIVC_PROGRAM, CYCLE_PROGRAM], cwd=ROOT, env=env)}
    for which, program in (("ivc", CYCLE_PROGRAM), ("trie", TRIE_PROGRAM)):
        children[which] = subprocess.Popen(
            [sys.executable, "-c", PORT_CHILD, str(out), which, program],
            cwd=ROOT, env=env)
    # this module's 2^17 SRS stays out of the process's memory after it
    # (other modules' keys are sized by the SRS in memory)
    mp = pytest.MonkeyPatch()
    mp.setattr(hyperkzg, "_SRS_MEM", {})
    try:
        native.build_host()
        store = Store(BN256_SCALAR, device="cpu")
        cprover = psc.SuperNovaCycleProver(rc=1, lang=sha256_lang(),
                                           device="cpu")
        cpp, cproof, cframes = cprover.evaluate_and_prove(
            store, read_with_default_state(store, CYCLE_PROGRAM), limit=50)
        # the compression's host C++ releases the interpreter lock: it
        # runs in a thread while the NIVC prover synthesizes here
        with ThreadPoolExecutor(max_workers=1) as ex:
            compressed = ex.submit(psc.compress_sn_cycle, cpp, cproof)
            nprover = sn.SuperNovaProver(rc=1, lang=sha256_lang(),
                                         device="cpu")
            npp, nproof, nframes = nprover.evaluate_and_prove(
                store, read_with_default_state(store, NIVC_PROGRAM),
                limit=50)
            LurkProof(nproof, 1, "bn256", "supernova").persist("sha256-nivc")
            write(out / "port-nivc", "sha256-nivc")
            ccp = compressed.result()
        changed = dataclasses.replace(ccp, zn=[(ccp.zn[0] + 1) % P1]
                                      + ccp.zn[1:])
        write(out / "port-cycle", dict(
            proof=cycle_io.to_jax(cycle_io.plain(cproof)),
            compressed=sn_cycle_compressed_to_jax(ccp),
            changed=sn_cycle_compressed_to_jax(changed)))
        yield dict(store=store, children=children, out=out,
                   npp=npp, nproof=nproof, nframes=nframes, cpp=cpp,
                   cproof=cproof, cframes=cframes, ccp=ccp, changed=changed)
    finally:
        mp.undo()
        for child in children.values():
            if child.poll() is None:
                child.kill()
            child.wait()


def write(path: pathlib.Path, obj) -> None:
    """Pickle ``obj`` to ``path`` in one step: a child polling for it
    never reads half a file."""
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def child_result(runs, child: str, name: str):
    assert runs["children"][child].wait() == 0
    with open(runs["out"] / name, "rb") as f:
        return pickle.load(f)


def test_sn_cycle_proof_matches_jax(runs):
    pp, proof = runs["cpp"], runs["cproof"]
    jproof = child_result(runs, "jax-cycle", "cycle")
    assert [f.pc for f in runs["cframes"]] == [0, 0, 1, 0]
    assert proof.n == 4 and pp.n_circuits == 2
    assert pp.pp_digest == jproof["pp_digest"]
    assert [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for s in pp.shapes1 + [pp.shape2]] == jproof["shapes"]
    assert jproof["gens"] == (1 << 17, 1 << 15)
    assert (len(pp.ck1.gens), len(pp.ck2.gens)) == jproof["gens"]
    got = cycle_io.plain(proof)
    for field in got:
        assert got[field] == jproof[field], field


def test_sn_cycle_verifiers_accept_each_others_proofs(runs):
    """The port's verifier on the JAX child's proof here; the JAX
    verifier on the port's proof in the child."""
    pp = runs["cpp"]
    jproof = child_result(runs, "jax-cycle", "cycle")
    assert jproof["verdicts"][0]
    assert psc.SuperNovaCycleProver.verify(pp, cycle_io.to_port(jproof, pp))
    # the pc-1 circuit's shape is on disk under the JAX package's key
    lang = sha256_lang()
    step, _ = psc.SuperNovaCycleProver(rc=1, lang=lang).setup_funcs()
    base = params_cache.shape_cache_key("bn256", 1, step) + hashlib.sha256(
        repr(params_cache.lang_key(lang)).encode()).hexdigest()[:8]
    shape = params_cache.load_shape(f"{base}_sn1", BN256_SCALAR)
    assert shape.digest == pp.shapes1[1].digest == jproof["shapes"][1][0]


def test_sn_cycle_compressed_proof_accepted_by_both(runs):
    """Two primary Spartan proofs and the secondary's: the port's
    verifier and the JAX one accept them and reject a changed zn."""
    pp, cp = runs["cpp"], runs["ccp"]
    assert len(cp.spartans1) == 2
    assert psc.verify_compressed_sn_cycle(pp, cp)
    assert not psc.verify_compressed_sn_cycle(pp, runs["changed"])
    verdicts = child_result(runs, "jax-cycle", "cycle")["verdicts"]
    assert verdicts[1:] == (True, False)


def test_nivc_proof_matches_jax(runs):
    pp, proof, frames = runs["npp"], runs["nproof"], runs["nframes"]
    jproof = child_result(runs, "jax-nivc", "nivc")
    assert [pc for pc, _, _ in proof.steps] == [0, 0, 0, 0, 1, 0]
    assert {pc: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for pc, s in pp.shapes.items()} == jproof["shapes"]
    assert len(pp.ck.gens) == jproof["gens"] == 1 << 17
    got = nivc_io.plain(proof)
    for field in ("steps", "final_witnesses", "z0", "zi"):
        assert got[field] == jproof[field], field
    store = runs["store"]
    assert store.fetch_num(frames[-1].output[0]) == (
        1 + store.fetch_num(runs["cframes"][-1].output[0])) % P1


def test_nivc_verifiers_accept_each_others_proofs(runs):
    """The port's verifier on the JAX child's proof, and rejecting its
    own proof with a changed final witness of circuit 1."""
    jproof = child_result(runs, "jax-nivc", "nivc")
    assert sn.verify(runs["npp"], nivc_io.to_port(jproof))
    bad = nivc_io.plain(runs["nproof"])
    bad["final_witnesses"][1][0][9] = (bad["final_witnesses"][1][0][9]
                                       + 1) % P1
    assert not sn.verify(runs["npp"], nivc_io.to_port(bad))


def test_repl_verifies_the_nivc_proof_file(runs):
    """The proof file of the NIVC proof (a circuit-1 step) verifies in a
    ``Repl`` with the sha256 ``Lang`` (circuit 1's shape from its blank
    frame, circuit 0's from the disk cache), here, and in the JAX
    ``Repl`` in the child (each circuit's shape synthesized): the JAX
    verifier accepts the port's proof."""
    repl = Repl(BN256_SCALAR, rc=1, backend="supernova", device="cpu")
    repl.lang = sha256_lang()
    assert repl.verify_proof_key("sha256-nivc")
    assert child_result(runs, "jax-nivc", "nivc")["repl_verified"]


def test_ivc_provers_prove_and_verify(runs):
    """The Nova cycle and the Nova IVC with sha256 in the step: each
    proof verifies and the cycle rejects a changed zn; the step's shape
    digest is the JAX one."""
    res = child_result(runs, "ivc", "ivc")
    jnivc = child_result(runs, "jax-nivc", "nivc")
    want = runs["store"].fetch_num(runs["cframes"][-1].output[0])
    assert res["cycle"] == (2, True, False, want)
    steps, ok, value, shape = res["nova"]
    assert (steps, ok, value) == (2, True, want)
    assert shape == jnivc["ivc_shape"]


def test_trie_program_proves_through_the_cycle(runs):
    res = child_result(runs, "trie", "trie")
    assert res["pcs"] == [0, 0, 0, 1, 0, 0, 0, 3, 0, 0, 2, 0]
    assert res["n"] == 12 and res["out"] == (8, 2)
    assert res["counts"] == [(32_562, 29_307), (22_070, 20_861),
                             (56_643, 55_999), (91_879, 91_224)]
    assert res["verified"] and not res["changed"]


def no_circuit_lang() -> Lang:
    """sha256's evaluation under a symbol of its own (so that no cached
    shape stands in for its circuit), with no circuit."""
    lang = Lang()
    lang.add_coprocessor(user_sym("sha256_nocircuit"), Coprocessor(
        1, sha256_coprocessor(1).evaluate))
    return lang


@pytest.mark.parametrize("backend", ["supernova", "supernova-cycle", "nova",
                                     "nova-fold"])
def test_a_coprocessor_without_a_circuit_is_not_provable(runs, backend):
    """The program's coprocessor step has no circuit to synthesize: each
    prover raises ``SynthesisError``, binding no unconstrained advice."""
    store, lang = runs["store"], no_circuit_lang()
    if backend == "supernova":
        p = sn.SuperNovaProver(rc=1, lang=lang, device="cpu")
    elif backend == "supernova-cycle":
        p = psc.SuperNovaCycleProver(rc=1, lang=lang, device="cpu",
                                     check_steps=True)
    elif backend == "nova":
        p = prover_cycle.CycleNovaProver(rc=1, lang=lang, device="cpu",
                                         check_steps=True)
    else:
        p = prover.NovaProver(rc=1, lang=lang, device="cpu")
    with pytest.raises(SynthesisError, match="no circuit synthesizer"):
        p.evaluate_and_prove(store, read_with_default_state(
            store, "(sha256_nocircuit 7)"), limit=50)
