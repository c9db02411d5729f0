"""The chain server's proved stream against the JAX package on the CPU:
the port's ``StreamState`` with its incremental Nova cycle proof
(``CycleNovaProver.prove_incremental``), its session dumps
(``cycle_snark_{to,from}_json``) and its compression, held against the
JAX ``prove_incremental`` on the same frames. Integers only: tolerance
0.

- ``StreamState`` at rc = 2 on an echo stream (6 frames, 3 steps a
  call; the counter's 14 frames a call would double the file's time),
  each call a proving POST to ``/chain``, so that the fork pool of step
  witnesses forks from the server's handler thread: after each of
  three calls the port's accumulator, as
  ``cycle_snark_to_json``, equals the JAX accumulator field by field;
  the dumped session resumes in a fresh store and folds a fourth call
  to the JAX package's accumulator (the folded ``Az1|Bz1|Cz1``
  recomputed after the resume); that call compresses and verifies, and
  the finished proof verifies. The JAX ``verify_compressed_cycle``
  accepts the compressed proof, read by the JAX reader from the port's
  JSON, and rejects it with a changed zn.
- ``prove_incremental`` raises ``ValueError`` for a snark of other
  parameters and for one that does not chain, and leaves it as it was.

This process imports no JAX, so that the JAX side starts early. It runs
in two children. The prover (the host C++ of its steps built in
threads; its Poseidon on its Python path) folds while the port proves
here. The verifier first synthesizes the JAX secondary shape and makes
the JAX keys into the cache the prover reads (so that the prover
synthesizes only its primary shape), then loads the JAX public
parameters once the prover has made them, and verifies the port's
compressed proof as soon as it is written.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest

from lurk_tpu_torch import native
from lurk_tpu_torch.cli import chain_server as cs
from lurk_tpu_torch.cli.lurk_proof import (
    compressed_cycle_to_json, cycle_snark_to_json,
)
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem import dummy_channel
from lurk_tpu_torch.lem import evaluation as ev
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import hyperkzg, nova_cycle
from lurk_tpu_torch.proof import prover_cycle as pcy
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
P1 = BN256_SCALAR.modulus
ECHO = "(letrec ((echo (lambda (x) (cons x echo)))) echo)"
RC = 2
ARGS = [3, 4, 5, 10]
# the primary key's length at RC: next_pow2 of the augmented step's
# 43,7xx constraints
KEY1 = 1 << 16

# The JAX prover: the host libraries of its steps compile in threads
# while it evaluates and synthesizes. It makes StreamState.chain's frames
# (lurk_tpu/cli/chain_server.py:156-172) for each argument, folds them
# with CycleNovaProver.prove_incremental, marks its public parameters
# made after the first call, and writes each call's accumulator
# (cycle_snark_to_json) and result.
JAX_PROVER = r'''
import contextlib, json, os, sys
from concurrent.futures import ThreadPoolExecutor
import lurk_tpu.native as native
out, rc, src, args = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    json.loads(sys.argv[4])
load = native.load
native._LOAD_LOCK = contextlib.nullcontext()
pool = ThreadPoolExecutor(5)
builds = {n: pool.submit(load, n) for n in ("msm", "r1cs")}
native.load = lambda name: builds[name].result() if name in builds \
    else load(name)
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.cli.lurk_proof import cycle_snark_to_json
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.lem import evaluation as ev
from lurk_tpu.parser import read_with_default_state
from lurk_tpu.proof.prover_cycle import CycleNovaProver
from lurk_tpu.store.core import Store
store = Store(BN256_SCALAR, use_device=False)
callable_ = ev.evaluate(None, read_with_default_state(store, src), store,
                        1000)[-1].output[0]
prover = CycleNovaProver(rc=rc)
snark = result = None
snarks, results = [], []
for arg in args:
    ch = ev.dummy_channel()
    if result is None:
        ch.feed(store.num(arg))
        frames = ev.start_stream(None, callable_, store, 1000, ch)
    else:
        ch.feed(store.intern_nil())
        ch.feed(store.num(arg))
        inp = [store.cons(result, callable_), store.intern_empty_env(),
               store.cont_stream_pause()]
        frames = ev.resume_stream(None, inp, store, 1000, ch)
    result, callable_ = store.fetch_cons(frames[-1].output[0])
    results.append(store.fetch_num(result))
    pp, snark = prover.prove_incremental(store, frames, init=snark)
    snarks.append(cycle_snark_to_json(snark))
    if len(snarks) == 1:
        open(os.path.join(out, "pp_made"), "w").close()
assert all(b.result() is not None for b in builds.values())
with open(os.path.join(out, "jax_snarks.json"), "w") as f:
    json.dump(dict(snarks=snarks, results=results,
                   pp_digest=pp.pp_digest), f)
'''

# The JAX verifier. First, while the prover synthesizes its primary
# shape, it synthesizes the JAX secondary shape (as
# CyclePublicParams.setup does, cached under the key cycle_public_params
# gives it) and makes both keys (the Grumpkin generators, the BN254 SRS
# of the primary's length), into $LURK_TPU_CACHE for the prover, its
# own host libraries compiling in threads meanwhile. Once the prover has
# made the public parameters, it loads them from the cache; once the
# port's compressed proofs are written, it reads them with the JAX
# reader and verifies each.
JAX_VERIFIER = r'''
import contextlib, hashlib, json, os, sys, time
from concurrent.futures import ThreadPoolExecutor
import lurk_tpu.native as native
out, rc, n1 = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
load = native.load
native._LOAD_LOCK = contextlib.nullcontext()
pool = ThreadPoolExecutor(3)
builds = {n: pool.submit(load, n) for n in ("srs", "pedersen", "spartan")}
native.load = lambda name: builds[name].result() if name in builds \
    else load(name)
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.cli.lurk_proof import compressed_cycle_from_json
from lurk_tpu.curves.weierstrass import CURVE_FOR_FIELD
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.proof import augmented, hyperkzg, nova, nova_cycle, params_cache
from lurk_tpu.proof.prover_cycle import (CycleNovaProver,
                                         cycle_public_params,
                                         verify_compressed_cycle)
from lurk_tpu.r1cs.cs import ConstraintSystem
from lurk_tpu.store.core import Store
curve1 = CURVE_FOR_FIELD[BN256_SCALAR.name]
field2 = curve1.base
curve2 = CURVE_FOR_FIELD[field2.name]
step = CycleNovaProver(rc=rc).step_func()
base = params_cache.shape_cache_key(BN256_SCALAR.name, rc, step) + \
    hashlib.sha256(repr(()).encode()).hexdigest()[:8]
def synth2():
    cfg = augmented.AugmentedCfg(curve_other=curve1,
                                 p_other=BN256_SCALAR.modulus, io_arity=0,
                                 fold_at_base=True)
    w = augmented.AugmentedWitness(0, 0, 0, 0, [], [],
                                   nova_cycle._default_relaxed(), None,
                                   [0, 0], None)
    cs = ConstraintSystem(field2)
    augmented.synthesize_augmented(cs, cfg, w)
    return nova.R1CSShape(cs)
shape2 = params_cache.cached_shape(f"{base}_cyc2", field2, synth2)
n2 = max(shape2.num_aux, shape2.num_constraints, shape2.num_inputs, 2)
nova.CommitmentKey.setup(curve2, b"lurk_tpu.ck." + curve2.name.encode(),
                         1 << (n2 - 1).bit_length())
hyperkzg.load_srs(n1)
def wait_for(name):
    path = os.path.join(out, name)
    for _ in range(12000):
        if os.path.exists(path):
            return path
        time.sleep(0.05)
    raise TimeoutError(name)
wait_for("pp_made")
pp = cycle_public_params(Store(BN256_SCALAR, use_device=False), rc, step,
                         None)
assert len(pp.ck1.gens) == n1
with open(wait_for("port_compressed.json")) as f:
    port = json.load(f)
verdicts = {name: verify_compressed_cycle(pp, compressed_cycle_from_json(d))
            for name, d in port.items()}
with open(os.path.join(out, "jax_verdicts.json"), "w") as f:
    json.dump(verdicts, f)
'''


def port_store() -> Store:
    return Store(BN256_SCALAR, device="cpu")


def post_chain(state, n: int) -> dict:
    """A proving ``/chain`` call with the argument ``n`` to ``state``
    served over HTTP on a free port: the server's handler thread proves,
    so the fork pool forks from it (3 chunks a call)."""
    server = cs.serve(state, port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/chain",
            data=json.dumps({"arg_num": n, "prove": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()


def write_json(path: pathlib.Path, obj) -> None:
    """Write JSON in one step: a child polling for it never reads half a
    file."""
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """The port's StreamState over the echo stream at RC, served: calls
    1-3 proved without compression, the session resumed in a fresh
    store, call 4 proved, compressed and verified; the JAX prover's
    accumulators and the JAX verifier's verdicts on the compressed
    proof."""
    out = tmp_path_factory.mktemp("jax_chain_stream")
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    children = [
        subprocess.Popen([sys.executable, "-c", JAX_PROVER, str(out),
                          str(RC), ECHO, json.dumps(ARGS)], cwd=ROOT,
                         env=env),
        subprocess.Popen([sys.executable, "-c", JAX_VERIFIER, str(out),
                          str(RC), str(KEY1)], cwd=ROOT, env=env)]
    mp = pytest.MonkeyPatch()
    # the keys of a fresh process: no SRS or parameters in memory
    mp.setattr(hyperkzg, "_SRS_MEM", {})
    mp.setattr(pcy, "_PP_CACHE", {})
    try:
        native.build_host()
        store = port_store()
        callable_ = ev.evaluate(None, read_with_default_state(store, ECHO),
                                store, 1000)[-1].output[0]
        session = out / "session.json"
        state = cs.StreamState(store, callable_, rc=RC, limit=1000,
                               session=session)
        resps, snarks = [], []
        with pytest.MonkeyPatch.context() as stub:
            stub.setattr(cs, "_compress_and_verify",
                         lambda pp, proof, resp: resp.update(
                             proof_steps=proof.n))
            for n in ARGS[:3]:
                resps.append(post_chain(state, n))
                snarks.append(cycle_snark_to_json(state.snark))
        dumped = json.loads(session.read_text())
        resumed = cs.StreamState.resume(session, port_store())
        resumed_json = cycle_snark_to_json(resumed.snark)
        abc1_on_resume = resumed.snark._abc1
        compressed = []

        def recording(pp, proof):
            compressed.append(pcy.compress_cycle(pp, proof))
            return compressed[-1]
        mp.setattr(cs, "compress_cycle", recording)
        resps.append(post_chain(resumed, ARGS[3]))
        snarks.append(cycle_snark_to_json(resumed.snark))
        cp = compressed[0]
        zn = list(cp.zn)
        zn[1] = (zn[1] + 1) % P1
        bad = dataclasses.replace(cp, zn=zn)
        write_json(out / "port_compressed.json",
                   {"stream": compressed_cycle_to_json(cp),
                    "changed_zn": compressed_cycle_to_json(bad)})
        for child in children:
            assert child.wait(timeout=600) == 0
        jax = json.loads((out / "jax_snarks.json").read_text())
        jax["verdicts"] = json.loads((out / "jax_verdicts.json").read_text())
        yield dict(resumed=resumed, resps=resps, snarks=snarks,
                   dumped=dumped, resumed_json=resumed_json,
                   abc1_on_resume=abc1_on_resume, cp=cp, bad=bad, jax=jax)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()
        mp.undo()


def test_stream_accumulators_match_jax(stream):
    """After each call, cycle_snark_to_json of the port's accumulator
    equals the JAX one field by field; the fourth call's was folded by
    the resumed session."""
    jax = stream["jax"]["snarks"]
    assert len(stream["snarks"]) == len(jax) == 4
    for k, (got, want) in enumerate(zip(stream["snarks"], jax)):
        assert list(got) == list(want)
        for field in want:
            assert got[field] == want[field], (k, field)
    assert stream["resumed"].pp.pp_digest == stream["jax"]["pp_digest"]


def test_stream_responses(stream):
    resps = stream["resps"]
    assert [int(r["result"]["root"]["digest"], 16) for r in resps] == \
        ARGS == stream["jax"]["results"]
    assert [r["calls"] for r in resps] == [1, 2, 3, 4]
    assert [r["proof_steps"] for r in resps] == [3, 6, 9, 12]
    assert "proof_verified" not in resps[0] and resps[3]["proof_verified"]
    assert resps[3]["next_callable"] == resps[0]["next_callable"]


def test_resumed_stream_session(stream):
    """The dumped accumulator is the live one; the resumed snark folds
    on, with its Az1|Bz1|Cz1 recomputed, into a proof that verifies."""
    assert stream["dumped"]["snark"] == stream["snarks"][2] == \
        stream["resumed_json"]
    assert stream["dumped"]["calls"] == 3
    assert stream["abc1_on_resume"] is None
    resumed = stream["resumed"]
    assert resumed.snark._abc1 is not None and resumed.calls == 4
    assert pcy.CycleNovaProver.verify(resumed.pp, resumed.snark.finish())
    assert cycle_snark_to_json(resumed.snark) == stream["snarks"][3]


def test_compressed_stream_proof_accepted_by_both(stream):
    pp = stream["resumed"].pp
    assert stream["cp"].n == 12
    assert pcy.verify_compressed_cycle(pp, stream["cp"])
    assert not pcy.verify_compressed_cycle(pp, stream["bad"])
    assert stream["jax"]["verdicts"] == {"stream": True, "changed_zn": False}


def test_prove_incremental_raises_on_a_foreign_snark(stream):
    resumed = stream["resumed"]
    store = resumed.store
    ch = dummy_channel()
    ch.feed(store.num(1))
    frames = ev.start_stream(None, resumed.first_callable, store, 1000, ch)
    before = cycle_snark_to_json(resumed.snark)
    with pytest.raises(ValueError, match="does not chain"):
        resumed.prover.prove_incremental(store, frames, init=resumed.snark)
    pp = resumed.pp
    other = nova_cycle.CycleSNARK(
        dataclasses.replace(pp, pp_digest=pp.pp_digest + 1),
        [0] * pp.io_arity)
    with pytest.raises(ValueError, match="other public parameters"):
        resumed.prover.prove_incremental(store, frames, init=other)
    assert cycle_snark_to_json(resumed.snark) == before
