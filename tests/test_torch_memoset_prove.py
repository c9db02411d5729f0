"""The port's memoset provers (``lurk_tpu_torch.coroutine.prove`` and
``prove_cycle``) against the JAX package on the CPU. Integers only:
tolerance 0.

- ``MemosetProver(rc=3, DemoCircuitQuery(), device="cpu")`` proves the
  demo factorial of 5 (6 keys, 2 steps) into the JAX prover's proof,
  field by field: the steps (index, instance, cross-term commitment),
  the final witnesses, z0 and zi, the shapes and the key's length.
- ``MemosetCycleProver(rc=1, ToplevelCircuitQuery(...), device="cpu")``
  proves the toplevel's ``(even 1)``: its chain starts at circuit 1 and
  goes on at circuit 2 (``base_allowed``, shapes synthesized with no
  disk cache), into the JAX cycle proof, field by field, with the same
  public-parameter digest and shapes.
- Each package's verifier accepts the other's proofs; both reject the
  NIVC proof with a changed zi[7] and with a changed step input, and the
  cycle proof with a changed zn[7].
- The provers take their key's device from the caller (``cuda`` by
  default, which raises without a card), and an unsatisfied step raises
  ``SynthesisError`` under ``check_steps``.

The JAX side proves in a child process (its host C++ built in threads of
the child meanwhile; its Poseidon on its Python path) while the port
proves here; once the port's proofs are written, the child verifies
them.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import pytest

import lurk_tpu.coroutine.prove as jax_prove
from lurk_tpu_torch import native
from lurk_tpu_torch.coroutine import prove, prove_cycle
from lurk_tpu_torch.coroutine.circuit import DemoCircuitQuery
from lurk_tpu_torch.coroutine.memoset import DemoQuery, Scope
from lurk_tpu_torch.coroutine.toplevel import ToplevelCircuitQuery, scope_for
from lurk_tpu_torch.examples import sample_toplevel
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.proof import hyperkzg
from lurk_tpu_torch.r1cs.cs import SynthesisError
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401
from test_torch_nivc import plain as nivc_plain
from test_torch_nivc import to_jax as nivc_to_jax
from test_torch_nivc import to_port as nivc_to_port
from test_torch_supernova_cycle import plain as cycle_plain
from test_torch_supernova_cycle import to_jax as cycle_to_jax
from test_torch_supernova_cycle import to_port as cycle_to_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = BN256_SCALAR.modulus

# The JAX side, run as a child process: its host libraries (msm, srs,
# pedersen, r1cs) compile in threads of the child while it evaluates and
# synthesizes (its loader compiles one library at a time under a lock,
# which the threads do without); its Poseidon runs its Python path. It
# proves the demo factorial through MemosetProver and (even 1) through
# MemosetCycleProver, then, once the parent has written the port's
# proofs (as JAX objects), verifies them.
JAX_CHILD = r'''
import contextlib, os, pickle, sys, time
from concurrent.futures import ThreadPoolExecutor
import lurk_tpu.native as native
out_dir = sys.argv[1]
load = native.load
native._LOAD_LOCK = contextlib.nullcontext()
pool = ThreadPoolExecutor(4)
builds = {n: pool.submit(load, n) for n in ("msm", "srs", "pedersen", "r1cs")}
native.load = lambda name: builds[name].result() if name in builds \
    else load(name)
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.coroutine import prove as mp, prove_cycle as mpc
from lurk_tpu.coroutine.circuit import DemoCircuitQuery
from lurk_tpu.coroutine.memoset import DemoQuery, Scope
from lurk_tpu.coroutine.toplevel import ToplevelCircuitQuery, scope_for
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.store.core import Store
from test_toplevel import _sample_toplevel
shape = lambda s: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
rel = lambda u: (u.comm_w, u.comm_e, list(u.x), u.u)
wit = lambda w: (list(w.w), list(w.e))

store = Store(BN256_SCALAR, use_device=False)
scope = Scope(store, DemoQuery, default_rc=3)
result = scope.query(DemoQuery(store.num(5)).to_ptr(store))
scope.finalize_transcript()
pp, proof = mp.MemosetProver(3, DemoCircuitQuery()).prove_from_scope(scope)
nivc = dict(result=store.fetch_num(result), r=scope.r,
            shapes={i: shape(s) for i, s in pp.shapes.items()},
            gens=len(pp.ck.gens),
            steps=[(i, inst.comm_w, list(inst.x), comm_t)
                   for i, inst, comm_t in proof.steps],
            final_witnesses={i: wit(w)
                             for i, w in proof.final_witnesses.items()},
            z0=proof.z0, zi=proof.zi)

toplevel, _, even, _ = _sample_toplevel()
store = Store(BN256_SCALAR, use_device=False)
cscope = scope_for(toplevel, store, default_rc=1)
result = cscope.query(cscope.query_cls(even, [store.num(1)]).to_ptr(store))
cscope.finalize_transcript()
cpp, cproof = mpc.MemosetCycleProver(
    1, ToplevelCircuitQuery(toplevel)).prove_from_scope(cscope)
cycle = dict(result=store.fetch_num(result), r=cscope.r,
             pp_digest=cpp.pp_digest,
             shapes=[shape(s) for s in cpp.shapes1 + [cpp.shape2]],
             gens=(len(cpp.ck1.gens), len(cpp.ck2.gens)), n=cproof.n,
             z0=cproof.z0, zn=cproof.zn, pc_n=cproof.pc_n,
             u1s=[rel(u) for u in cproof.u1s],
             w1s=[wit(w) for w in cproof.w1s], u2=rel(cproof.u2),
             u2_pending=(cproof.u2_pending.comm_w,
                         list(cproof.u2_pending.x)),
             comm_t_last=cproof.comm_t_last,
             w2_folded=wit(cproof.w2_folded))
assert all(b.result() is not None for b in builds.values())

path = os.path.join(out_dir, "port")
for _ in range(18000):
    if os.path.exists(path):
        break
    time.sleep(0.05)
with open(path, "rb") as f:
    port = pickle.load(f)
verdicts = {name: (mpc.verify(cpp, p) if name.startswith("cycle")
                   else mp.verify(pp, p)) for name, p in port.items()}
with open(os.path.join(out_dir, "jax"), "wb") as f:
    pickle.dump(dict(nivc=nivc, cycle=cycle, verdicts=verdicts), f)
'''


def write(path: pathlib.Path, obj) -> None:
    """Pickle ``obj`` to ``path`` in one step: a child polling for it
    never reads half a file."""
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def memoset_to_jax(d: dict) -> "jax_prove.MemosetProof":
    p = nivc_to_jax(d)
    return jax_prove.MemosetProof(p.steps, p.final_witnesses, p.z0, p.zi)


def changed_zi(d: dict) -> dict:
    return dict(d, zi=[1 if k == 7 else v for k, v in enumerate(d["zi"])])


def changed_step_input(d: dict) -> dict:
    """A plain NIVC proof whose first step's first input is changed."""
    i, w, x, t = d["steps"][0]
    return dict(d, steps=[(i, w, [(x[0] + 1) % P] + x[1:], t)]
                + d["steps"][1:])


def changed_zn(d: dict) -> dict:
    return dict(d, zn=[1 if k == 7 else v for k, v in enumerate(d["zn"])])


def even_one_scope():
    toplevel, _, even, _ = sample_toplevel()
    store = Store(BN256_SCALAR, device="cpu")
    scope = scope_for(toplevel, store, default_rc=1)
    result = scope.query(scope.query_cls(even, [store.num(1)]).to_ptr(store))
    scope.finalize_transcript()
    return toplevel, scope, result


def demo_scope(rc: int = 3):
    store = Store(BN256_SCALAR, device="cpu")
    scope = Scope(store, DemoQuery, default_rc=rc)
    result = scope.query(DemoQuery(store.num(5)).to_ptr(store))
    scope.finalize_transcript()
    return scope, result


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """The port's two proofs, the JAX child's and its verdicts on the
    port's proofs and their changed copies."""
    out = tmp_path_factory.mktemp("jax_memoset")
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    mp = pytest.MonkeyPatch()
    # a key takes the length of an SRS already in memory: start empty
    mp.setattr(hyperkzg, "_SRS_MEM", {})
    mp.setattr(prove_cycle, "_PP_CACHE", {})
    child = None
    try:
        child = subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(out)], cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": os.pathsep.join([str(ROOT),
                                                str(ROOT / "tests")])})
        native.build_host()
        scope, result = demo_scope()
        pp, proof = prove.MemosetProver(
            3, DemoCircuitQuery(), device="cpu").prove_from_scope(scope)
        toplevel, cscope, cresult = even_one_scope()
        cprover = prove_cycle.MemosetCycleProver(
            1, ToplevelCircuitQuery(toplevel), device="cpu")
        cpp, cproof = cprover.prove_from_scope(cscope)
        nd, cd = nivc_plain(proof), cycle_plain(cproof)
        write(out / "port", {
            "nivc": memoset_to_jax(nd),
            "nivc zi[7]": memoset_to_jax(changed_zi(nd)),
            "nivc step input": memoset_to_jax(changed_step_input(nd)),
            "cycle": cycle_to_jax(cd),
            "cycle zn[7]": cycle_to_jax(changed_zn(cd))})
        assert child.wait() == 0
        with open(out / "jax", "rb") as f:
            jax = pickle.load(f)
        yield dict(scope=scope, result=result, pp=pp, proof=proof,
                   cscope=cscope, cresult=cresult, cprover=cprover,
                   cpp=cpp, cproof=cproof, jax=jax)
    finally:
        mp.undo()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()


def test_memoset_proof_matches_jax(proofs):
    pp, proof, j = proofs["pp"], proofs["proof"], proofs["jax"]["nivc"]
    assert proofs["scope"].store.fetch_num(proofs["result"]) == \
        j["result"] == 120
    assert proofs["scope"].r == j["r"]
    assert {i: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for i, s in pp.shapes.items()} == j["shapes"]
    assert len(pp.ck.gens) == j["gens"]
    assert pp.ck.device.type == "cpu"
    got = nivc_plain(proof)
    assert [i for i, _, _, _ in got["steps"]] == [0, 0]
    for field in ("steps", "final_witnesses", "z0", "zi"):
        assert got[field] == j[field], field
    assert proof.zi[7] == 0
    assert proof.zi[9] == proofs["scope"].store.hash_ptr(
        proofs["scope"].transcript.acc).digest
    assert proof.zi[11] == proofs["scope"].r


def test_memoset_verifiers_accept_each_others_proofs(proofs):
    pp, proof, jax = proofs["pp"], proofs["proof"], proofs["jax"]
    assert prove.verify(pp, proof)
    assert prove.verify(pp, nivc_to_port(jax["nivc"]))
    assert jax["verdicts"]["nivc"]
    for change in (changed_zi, changed_step_input):
        assert not prove.verify(pp, nivc_to_port(change(jax["nivc"])))
    assert not jax["verdicts"]["nivc zi[7]"]
    assert not jax["verdicts"]["nivc step input"]


def test_cycle_proof_starts_at_circuit_1_and_matches_jax(proofs):
    cpp, cproof, j = proofs["cpp"], proofs["cproof"], proofs["jax"]["cycle"]
    assert proofs["cscope"].store.fetch_num(proofs["cresult"]) == \
        j["result"] == 0
    assert [st.index for st in proofs["cprover"].steps(proofs["cscope"])] \
        == [1, 2]
    assert cpp.n_circuits == 3 and all(c.base_allowed for c in cpp.cfg1s)
    assert proofs["cscope"].r == j["r"]
    assert cpp.pp_digest == j["pp_digest"]
    assert [(s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for s in cpp.shapes1 + [cpp.shape2]] == j["shapes"]
    assert (len(cpp.ck1.gens), len(cpp.ck2.gens)) == j["gens"]
    got = cycle_plain(cproof)
    for field in got:
        assert got[field] == j[field], field
    # circuit 0 (factorial) never ran: its accumulator is the default
    assert cproof.u1s[0].u == 0 and cproof.u1s[1].u != 0 and \
        cproof.u1s[2].u != 0


def test_cycle_verifiers_accept_each_others_proofs(proofs):
    cpp, jax = proofs["cpp"], proofs["jax"]
    assert prove_cycle.verify(cpp, proofs["cproof"])
    assert prove_cycle.verify(cpp, cycle_to_port(jax["cycle"], cpp))
    assert jax["verdicts"]["cycle"]
    assert not prove_cycle.verify(
        cpp, cycle_to_port(changed_zn(jax["cycle"]), cpp))
    assert not jax["verdicts"]["cycle zn[7]"]


def test_provers_commit_on_the_callers_device(proofs):
    """``None`` means ``cuda``: the key and the cycle parameters raise
    on a machine without a card (here) before anything is committed."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        prove.MemosetPublicParams.setup(proofs["pp"].shapes)
    with pytest.raises(RuntimeError, match="cuda"):
        prove_cycle.MemosetCycleProver(
            1, DemoCircuitQuery()).params_key(BN256_SCALAR, 1)


def test_an_unsatisfied_step_raises(monkeypatch):
    """A host z chaining that disagrees with the circuit (acc off by one)
    makes check_steps raise SynthesisError."""
    next_z = prove.MemosetProver.next_z

    def off_by_one(self, scope, step, z, tr_ptr):
        z_out, tr_ptr = next_z(self, scope, step, z, tr_ptr)
        return [(v + 1) % P if k == 7 else v
                for k, v in enumerate(z_out)], tr_ptr
    monkeypatch.setattr(prove.MemosetProver, "next_z", off_by_one)
    scope, _ = demo_scope(rc=1)
    with pytest.raises(SynthesisError):
        prove.MemosetProver(1, DemoCircuitQuery(), check_steps=True,
                            device="cpu").prove_from_scope(scope)

