"""The port's circom coprocessor (``lurk_tpu_torch.coproc.circom``) and
the CLI's ``circom`` subcommand against the JAX package's on the CPU.
Integers and bytes only: tolerance 0.

- ``.r1cs`` and ``.wtns`` files are read and written alike, byte for
  byte; a gadget packaged by either package loads in the other, and the
  two ``meta.json`` files are equal.
- ``CircomCircuit`` on the 1-row square gadget (``y = x * x``) and on a
  64-row chain (``x_{i+1} = x_i * x_i``): the constraints and the
  witness equal the JAX synthesis row by row in the concrete, blank and
  dummy modes, each mode satisfied and all three of one shape; a prime
  other than the Lurk field's raises ``SynthesisError`` in both.
- The coprocessor evaluates ``(square 7)`` to 49 and the chain to
  ``7^(2^64)``; an unsatisfied witness raises ``ValueError`` (the JAX
  package asserts).
- ``python -m lurk_tpu_torch.cli circom`` prints what the JAX CLI prints
  and writes the same files; a bad reference and a missing folder fail
  alike.
- The in-memory parameter key: two gadgets of one symbol and different
  r1cs never share it, and ``lang_circuits`` of a 16,384-row gadget
  takes under 10 ms.
- One NIVC proof of ``(square 7)`` at rc = 1 over BN256
  (``SuperNovaProver``, pcs [0, 0, 1, 0]) equals the JAX prover's field
  by field (both shapes included); each verifier accepts the other's
  proof and rejects a changed one; the JAX ``verify_compressed`` accepts
  the port's compressed proof and rejects a changed step input, as the
  port's does.

The JAX side of the proof runs in a child process (its host C++ built in
threads of the child meanwhile; its Poseidon on its Python path), which
also verifies the port's proofs once the parent has written them.
"""

import contextlib
import dataclasses
import io
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest

import lurk_tpu.cli.__main__ as jax_cli
import lurk_tpu.coproc.circom as jax_circom
import lurk_tpu.r1cs.cs as jax_cs
import lurk_tpu.r1cs.gadgets as jax_gadgets
from lurk_tpu.fields import FIELDS as JAX_FIELDS
from lurk_tpu.lem.circuit import AllocatedPtr as JaxAllocatedPtr
from lurk_tpu_torch import native
from lurk_tpu_torch.cli.__main__ import main as port_cli
from lurk_tpu_torch.coproc import circom
from lurk_tpu_torch.fields import BN256_SCALAR, VESTA_SCALAR
from lurk_tpu_torch.lem.circuit import AllocatedPtr
from lurk_tpu_torch.lem.evaluation import Lang
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import hyperkzg, nova
from lurk_tpu_torch.proof import supernova as sn
from lurk_tpu_torch.proof.params_cache import lang_circuits
from lurk_tpu_torch.r1cs import cs as port_cs
from lurk_tpu_torch.r1cs import gadgets as port_gadgets
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import user_sym
from lurk_tpu_torch.tags import ExprTag
from test_circom import _write_r1cs
from test_torch_field import one_torch_thread  # noqa: F401
from test_torch_nivc import compressed_to_jax, plain, to_jax, to_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = BN256_SCALAR.modulus
SQUARE = "tester/square"
CHAIN_ROWS = 64


def chain_r1cs(path, rows: int) -> None:
    """``x_{i+1} = x_i * x_i`` for i < rows, in circom's wire order:
    0 ONE, 1 the public output x_rows, 2 the public input x_0, then
    x_1 .. x_{rows-1}."""
    def wire(i):
        return 2 if i == 0 else (1 if i == rows else 2 + i)
    _write_r1cs(path, P, [({wire(i): 1}, {wire(i): 1}, {wire(i + 1): 1})
                          for i in range(rows)], rows + 2, 1, 1, 0)


def chain_witness(x: int, rows: int) -> list:
    xs = [x]
    for _ in range(rows):
        xs.append(xs[-1] * xs[-1] % P)
    return [1, xs[-1], x] + xs[1:-1]


def write_gadget(folder: pathlib.Path, name: str, rows: int) -> None:
    """``<name>.r1cs`` and ``<name>.wtns`` (x = 7) of a square chain
    (``rows`` = 1 is the square gadget), written by the JAX writers."""
    folder.mkdir(parents=True, exist_ok=True)
    chain_r1cs(folder / f"{name}.r1cs", rows)
    jax_circom.write_wtns(folder / f"{name}.wtns", chain_witness(7, rows), P)


@contextlib.contextmanager
def cache_at(path: pathlib.Path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LURK_TPU_CACHE", str(path))
        yield path


def test_files_read_and_written_alike(tmp_path):
    write_gadget(tmp_path, "chain", CHAIN_ROWS)
    wit = chain_witness(7, CHAIN_ROWS)
    circom.write_wtns(tmp_path / "port.wtns", wit, P)
    assert (tmp_path / "port.wtns").read_bytes() == \
        (tmp_path / "chain.wtns").read_bytes()
    assert circom.parse_wtns(tmp_path / "chain.wtns") == wit == \
        jax_circom.parse_wtns(tmp_path / "port.wtns")
    r, jr = (mod.parse_r1cs(tmp_path / "chain.r1cs")
             for mod in (circom, jax_circom))
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    assert (r.prime, r.n_wires, r.n_pub_out, r.n_pub_in, len(
        r.constraints)) == (P, CHAIN_ROWS + 2, 1, 1, CHAIN_ROWS)
    for mod in (circom, jax_circom):
        for parse, f in ((mod.parse_r1cs, "chain.wtns"),
                         (mod.parse_wtns, "chain.r1cs")):
            with pytest.raises(ValueError, match="bad magic"):
                parse(tmp_path / f)


def gadget_files(cache: pathlib.Path, ref: str) -> dict:
    d = cache / "circom" / ref
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_gadgets_load_in_the_other_package(tmp_path):
    write_gadget(tmp_path / "src", "square", 1)
    loaded = {}
    for maker, loader, cache in ((circom, jax_circom, tmp_path / "a"),
                                 (jax_circom, circom, tmp_path / "b")):
        with cache_at(cache):
            maker.create_circom_gadget(tmp_path / "src", SQUARE)
            loaded[cache.name] = loader.CircomGadget.load(SQUARE)
    files = gadget_files(tmp_path / "a", SQUARE)
    assert sorted(files) == ["meta.json", "square.r1cs", "square.wtns"]
    assert files == gadget_files(tmp_path / "b", SQUARE)
    for g in loaded.values():
        assert g.reference == SQUARE and g.static_wtns == [1, 49, 7]
        assert g.wasm_path is None and g.check_witness(g.static_wtns)
    assert dataclasses.asdict(loaded["a"].r1cs) == \
        dataclasses.asdict(loaded["b"].r1cs)


class _Shim:
    """The synthesizer a coprocessor circuit sees: its ``cs`` and
    whether the frame is blank."""

    def __init__(self, cs, blank=False):
        self.cs = cs
        self.ctx = type("C", (), {"blank": blank})()


def synthesize(pkg: str, gadget, field, mode: str):
    """The circuit of ``gadget`` on the argument 7 (``concrete``), on a
    blank frame, or with not_dummy false and a garbage argument
    (``dummy``): (constraints, witness, satisfied)."""
    cs_mod, g, ptr, circuit = (
        (port_cs, port_gadgets, AllocatedPtr, circom.CircomCircuit)
        if pkg == "port" else
        (jax_cs, jax_gadgets, JaxAllocatedPtr, jax_circom.CircomCircuit))
    cs = cs_mod.ConstraintSystem(field)
    nd = g.alloc_bit(cs, mode == "concrete")
    env = ptr(g.Num.constant(cs, int(ExprTag.Env)), g.alloc_num(cs, 0))
    cont = ptr(g.Num.constant(cs, 0x1000), g.alloc_num(cs, 0))
    arg = ptr(g.Num.constant(cs, int(ExprTag.Num)),
              g.alloc_num(cs, 999 if mode == "dummy" else 7))
    out = circuit(gadget).synthesize(_Shim(cs, mode == "blank"), nd,
                                     [arg, env, cont])
    assert out[1] is env and out[2] is cont
    return cs.constraints, cs.witness_vector(), cs.is_satisfied(), \
        out[0].hash.value


@pytest.fixture(scope="module")
def gadgets(tmp_path_factory):
    """The square and 64-row chain gadgets, each loaded by both
    packages."""
    base = tmp_path_factory.mktemp("circom")
    out = {}
    with cache_at(base / "cache"):
        for name, rows in (("square", 1), ("chain", CHAIN_ROWS)):
            write_gadget(base / "src", name, rows)
            circom.create_circom_gadget(base / "src", f"tester/{name}")
            out[name] = (circom.CircomGadget.load(f"tester/{name}"),
                         jax_circom.CircomGadget.load(f"tester/{name}"))
    return out


@pytest.mark.parametrize("name", ["square", "chain"])
def test_circuit_matches_jax_in_every_mode(gadgets, name):
    gadget, jgadget = gadgets[name]
    rows = len(gadget.r1cs.constraints)
    shape = None
    for mode in ("concrete", "blank", "dummy"):
        cons, wit, ok, out = synthesize("port", gadget, BN256_SCALAR, mode)
        jcons, jwit, jok, jout = synthesize(
            "jax", jgadget, JAX_FIELDS["bn256"], mode)
        assert len(cons) == len(jcons)
        for k, (row, jrow) in enumerate(zip(cons, jcons)):
            assert row == jrow, (mode, k)
        assert wit == jwit and out == jout, mode
        assert ok and jok, mode
        # 1 booleanity, the argument bound, 2 a row
        assert len(cons) == 2 + 2 * rows
        assert out == (chain_witness(7, rows)[1] if mode == "concrete"
                       else 0)
        if shape is None:
            shape = cons
        assert cons == shape, mode


def test_prime_mismatch_raises(gadgets):
    gadget, jgadget = gadgets["square"]
    with pytest.raises(port_cs.SynthesisError, match="different prime"):
        synthesize("port", gadget, VESTA_SCALAR, "concrete")
    with pytest.raises(jax_cs.SynthesisError, match="different prime"):
        synthesize("jax", jgadget, JAX_FIELDS["vesta"], "concrete")


def circom_lang(gadget, sym="square") -> Lang:
    lang = Lang()
    lang.add_coprocessor(user_sym(sym), circom.circom_coprocessor(gadget))
    return lang


def test_coprocessor_evaluates_and_refuses_a_bad_witness(gadgets):
    from lurk_tpu_torch.lem.evaluation import LangSetup, evaluate
    for name, expect in (("square", 49), ("chain", pow(7, 2 ** CHAIN_ROWS,
                                                       P))):
        gadget = gadgets[name][0]
        store = Store(BN256_SCALAR, device="cpu")
        frames = evaluate(LangSetup.nivc(circom_lang(gadget, name)),
                          read_with_default_state(store, f"({name} 7)"),
                          store, 50)
        assert [f.pc for f in frames] == [0, 0, 1, 0]
        assert store.fetch_num(frames[-1].output[0]) == expect
    bad = dataclasses.replace(gadgets["square"][0], static_wtns=[1, 50, 7])
    store = Store(BN256_SCALAR, device="cpu")
    with pytest.raises(ValueError, match="does not satisfy"):
        evaluate(LangSetup.nivc(circom_lang(bad)),
                 read_with_default_state(store, "(square 7)"), store, 50)


def run_cli(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_cli_subcommand_matches_jax(tmp_path):
    write_gadget(tmp_path / "src", "square", 1)
    argv = ["circom", str(tmp_path / "src"), "--name", SQUARE]
    outs = {}
    for who, fn in (("port", port_cli), ("jax", jax_cli.main)):
        with cache_at(tmp_path / who):
            outs[who] = run_cli(fn, argv + ["--prime", "bn128"])
            for bad, exc in ((["--name", "noslash"], ValueError),
                             (["--name", "tester/missing"],
                              FileNotFoundError)):
                with pytest.raises(exc) as e:
                    run_cli(fn, argv[:2] + bad)
                outs[who, bad[1]] = str(e.value).replace(str(tmp_path / who),
                                                        "<cache>")
    for key in ("noslash", "tester/missing"):
        assert outs["port", key] == outs["jax", key]
    for who in ("port", "jax"):
        dest = tmp_path / who / "circom" / SQUARE
        assert outs[who] == (0, f"Gadget packaged at {dest}\n")
    assert gadget_files(tmp_path / "port", SQUARE) == \
        gadget_files(tmp_path / "jax", SQUARE)


def test_parameter_key_names_the_gadget(tmp_path):
    """Two gadgets of one symbol with different r1cs (or witnesses) key
    apart; the same gadget loaded twice keys alike; the key of a
    16,384-row gadget is read in under 10 ms and holds no constraint."""
    with cache_at(tmp_path):
        for name, rows in (("square", 1), ("chain", 2)):
            write_gadget(tmp_path / "src", name, rows)
            circom.create_circom_gadget(tmp_path / "src", f"t/{name}")
        square, chain = (circom.CircomGadget.load(f"t/{n}")
                         for n in ("square", "chain"))
        again = circom.CircomGadget.load("t/square")
    renamed = circom.CircomGadget("t/square", chain.r1cs,
                                  static_wtns=square.static_wtns)
    other_wtns = dataclasses.replace(square, static_wtns=[1, 4, 2])
    keys = [lang_circuits(circom_lang(g))
            for g in (square, chain, renamed, other_wtns)]
    assert len(set(keys)) == 4
    assert lang_circuits(circom_lang(again)) == keys[0]
    big = circom.R1cs(P, 16386, 1, 1, 0, 16386, [
        ({2 + i: 1}, {2 + i: 1}, {3 + i if i < 16383 else 1: 1})
        for i in range(16384)])
    lang = circom_lang(circom.CircomGadget("t/big", big))
    t0 = time.perf_counter()
    key = lang_circuits(lang)
    assert time.perf_counter() - t0 < 0.01
    assert len(repr(key)) < 1000


# The JAX side, run as a child process: its host libraries (msm, srs,
# r1cs, spartan) compile in threads of the child while it evaluates and
# synthesizes (its loader compiles one library at a time under a lock,
# which the threads do without); its Poseidon runs its Python path.
# SuperNovaProver(rc=1) proves "(square 7)" with the gadget the parent
# packaged; once the parent has written the port's proofs (as JAX
# objects), the child verifies them.
JAX_CHILD = r'''
import contextlib, os, pickle, sys, time
from concurrent.futures import ThreadPoolExecutor
import lurk_tpu.native as native
out_dir = sys.argv[1]
load = native.load
native._LOAD_LOCK = contextlib.nullcontext()
pool = ThreadPoolExecutor(4)
builds = {n: pool.submit(load, n) for n in ("msm", "srs", "r1cs", "spartan")}
native.load = lambda name: builds[name].result() if name in builds \
    else load(name)
import lurk_tpu.native.poseidon
lurk_tpu.native.poseidon.available = lambda: False
from lurk_tpu.coproc.circom import CircomGadget, circom_coprocessor
from lurk_tpu.fields import BN256_SCALAR
from lurk_tpu.lem.evaluation import Lang
from lurk_tpu.parser import read_with_default_state
from lurk_tpu.proof import supernova as sn
from lurk_tpu.store.core import Store
from lurk_tpu.symbol import user_sym
lang = Lang()
lang.add_coprocessor(user_sym("square"),
                     circom_coprocessor(CircomGadget.load(sys.argv[2])))
store = Store(BN256_SCALAR, use_device=False)
pp, proof, frames = sn.SuperNovaProver(rc=1, lang=lang).evaluate_and_prove(
    store, read_with_default_state(store, "(square 7)"), limit=50)
assert all(b.result() is not None for b in builds.values())
out = dict(shapes={pc: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
                   for pc, s in pp.shapes.items()},
           gens=len(pp.ck.gens), pcs=[f.pc for f in frames],
           result=store.fetch_num(frames[-1].output[0]),
           steps=[(pc, inst.comm_w, list(inst.x), comm_t)
                  for pc, inst, comm_t in proof.steps],
           final_witnesses={pc: (list(w.w), list(w.e))
                            for pc, w in proof.final_witnesses.items()},
           z0=proof.z0, zi=proof.zi)
path = os.path.join(out_dir, "port")
for _ in range(18000):
    if os.path.exists(path):
        break
    time.sleep(0.05)
with open(path, "rb") as f:
    port = pickle.load(f)
out["verdicts"] = {name: (sn.verify_compressed if "compressed" in name
                          else sn.verify)(pp, p) for name, p in port.items()}
with open(os.path.join(out_dir, "jax"), "wb") as f:
    pickle.dump(out, f)
'''


def write(path: pathlib.Path, obj) -> None:
    """Pickle ``obj`` to ``path`` in one step: a child polling for it
    never reads half a file."""
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def changed_input(cp):
    """``cp`` with the first input of its circom step (circuit 1)
    changed."""
    k = [pc for pc, _, _ in cp.steps].index(1)
    pc, inst, comm_t = cp.steps[k]
    x = list(inst.x)
    x[0] = (x[0] + 1) % P
    steps = list(cp.steps)
    steps[k] = (pc, nova.R1CSInstance(inst.comm_w, x), comm_t)
    return dataclasses.replace(cp, steps=steps)


def changed_witness(d: dict) -> dict:
    """A plain proof with one entry of circuit 1's final W changed."""
    d = dict(d, final_witnesses=dict(d["final_witnesses"]))
    w, e = d["final_witnesses"][1]
    w = list(w)
    w[-1] = (w[-1] + 1) % P
    d["final_witnesses"][1] = (w, e)
    return d


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """The port's NIVC proof of ``(square 7)`` and its compressed form,
    the JAX child's proof and its verdicts on the port's proofs."""
    base = tmp_path_factory.mktemp("circom_nivc")
    out = base / "out"
    out.mkdir()
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    mp = pytest.MonkeyPatch()
    # the key takes the length of an SRS already in memory: start empty
    mp.setattr(hyperkzg, "_SRS_MEM", {})
    child = None
    try:
        write_gadget(base / "src", "square", 1)
        circom.create_circom_gadget(base / "src", SQUARE)
        child = subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(out), SQUARE], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT),
                 "JAX_PLATFORMS": "cpu"})
        native.build_host()
        store = Store(BN256_SCALAR, device="cpu")
        lang = circom_lang(circom.CircomGadget.load(SQUARE))
        pp, proof, frames = sn.SuperNovaProver(
            rc=1, lang=lang, device="cpu").evaluate_and_prove(
                store, read_with_default_state(store, "(square 7)"),
                limit=50)
        cp = sn.compress(pp, proof)
        write(out / "port", {
            "proof": to_jax(plain(proof)),
            "changed proof": to_jax(changed_witness(plain(proof))),
            "compressed": compressed_to_jax(cp),
            "changed compressed": compressed_to_jax(changed_input(cp))})
        assert child.wait() == 0
        with open(out / "jax", "rb") as f:
            jproof = pickle.load(f)
        yield dict(store=store, pp=pp, proof=proof, frames=frames, cp=cp,
                   jproof=jproof)
    finally:
        mp.undo()
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()


def test_nivc_proof_matches_jax(proofs):
    pp, proof, jproof = proofs["pp"], proofs["proof"], proofs["jproof"]
    assert [f.pc for f in proofs["frames"]] == jproof["pcs"] == [0, 0, 1, 0]
    assert proofs["store"].fetch_num(proofs["frames"][-1].output[0]) == \
        jproof["result"] == 49
    assert {pc: (s.digest, s.num_inputs, s.num_aux, s.num_constraints)
            for pc, s in pp.shapes.items()} == jproof["shapes"]
    assert len(pp.ck.gens) == jproof["gens"]
    got = plain(proof)
    assert [pc for pc, _, _, _ in got["steps"]] == [0, 0, 1, 0]
    for field in ("steps", "final_witnesses", "z0", "zi"):
        assert got[field] == jproof[field], field


def test_verifiers_accept_each_others_proofs(proofs):
    assert sn.verify(proofs["pp"], proofs["proof"])
    assert sn.verify(proofs["pp"], to_port(proofs["jproof"]))
    assert proofs["jproof"]["verdicts"]["proof"]
    assert not sn.verify(proofs["pp"],
                         to_port(changed_witness(proofs["jproof"])))
    assert not proofs["jproof"]["verdicts"]["changed proof"]


def test_compressed_proof_accepted_by_both(proofs):
    cp = proofs["cp"]
    assert sorted(cp.spartans) == [0, 1]
    assert sn.verify_compressed(proofs["pp"], cp)
    assert proofs["jproof"]["verdicts"]["compressed"]
    assert not sn.verify_compressed(proofs["pp"], changed_input(cp))
    assert not proofs["jproof"]["verdicts"]["changed compressed"]
