"""The port's coprocessors (``lurk_tpu_torch.coproc``: the gadgets,
sha256 and the trie, and ``lurk_tpu_torch.r1cs.sha256_gadget``) against
the JAX package on the CPU. Integers only: tolerance 0.

- The 7 gadget cases of ``tests/test_coproc_gadgets.py``, each run
  through both packages: the same values out, the same constraint and
  aux counts, every constraint satisfied.
- The sha256 gadget on ``tests/test_sha256_gadget.py``'s 4 messages:
  the digest equals ``hashlib``'s, and the counts, shape digest and
  witness equal the JAX gadget's.
- ``sha256_evaluate`` equals the JAX one; the NIVC sha256 circuit's
  frame (``Sha256Circuit(1)`` through ``make_cprocs_funcs``) has the
  JAX package's 100,305 constraints, 61,110 aux and shape digest.
- The trie's empty roots at heights 1-4 (the reference's anchors),
  ``Trie.insert`` and ``lookup`` against the JAX ``Trie``, the trie
  program of ``examples/benches.py`` (1,590 frames, 5 of them
  coprocessor frames, result 12688603180), and the blank ``New``,
  ``Lookup`` and ``Insert`` circuits at full height against the counts
  and shape digests the JAX package gives (its synthesis at full height
  takes about 50 s, so they are pinned here).
- Concrete ``Lookup`` and ``Insert`` witnesses equal the JAX circuits',
  entry by entry, with both packages' trie ``HEIGHT`` set to 4.
"""

import hashlib
import os
import pathlib
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

import lurk_tpu.coproc.gadgets as jax_gadgets
import lurk_tpu.coproc.sha256 as jax_sha256
import lurk_tpu.coproc.trie as jax_trie
import lurk_tpu.fields as jax_fields
import lurk_tpu.lem.circuit as jax_circuit
import lurk_tpu.r1cs.cs as jax_cs
import lurk_tpu.r1cs.gadgets as jax_r1cs_gadgets
import lurk_tpu.r1cs.sha256_gadget as jax_sha256_gadget
import lurk_tpu.store.core as jax_core
import lurk_tpu.symbol as jax_symbol
import lurk_tpu.tags as jax_tags
import lurk_tpu_torch.coproc.gadgets as gadgets
import lurk_tpu_torch.coproc.sha256 as sha256
import lurk_tpu_torch.coproc.trie as trie
import lurk_tpu_torch.fields as fields
import lurk_tpu_torch.lem.circuit as circuit
import lurk_tpu_torch.r1cs.cs as cs_mod
import lurk_tpu_torch.r1cs.gadgets as r1cs_gadgets
import lurk_tpu_torch.r1cs.sha256_gadget as sha256_gadget
import lurk_tpu_torch.store.core as core
import lurk_tpu_torch.symbol as symbol
import lurk_tpu_torch.tags as tags
from lurk_tpu_torch.examples import TRIE_PROGRAM, TRIE_RESULT
from lurk_tpu_torch.lem import evaluation as ev
from lurk_tpu_torch.lem.eval_step import make_cprocs_funcs
from lurk_tpu_torch.parser import read_with_default_state
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
from benches import TRIE_CODE  # noqa: E402

# each package's modules under the same names
PORT = types.SimpleNamespace(
    g=gadgets, sha256=sha256, trie=trie, fields=fields, circuit=circuit,
    cs=cs_mod, r1cs=r1cs_gadgets, sha256_gadget=sha256_gadget, core=core,
    symbol=symbol, tags=tags,
    store=lambda: core.Store(fields.BN256_SCALAR, device="cpu"))
JAX = types.SimpleNamespace(
    g=jax_gadgets, sha256=jax_sha256, trie=jax_trie, fields=jax_fields,
    circuit=jax_circuit, cs=jax_cs, r1cs=jax_r1cs_gadgets,
    sha256_gadget=jax_sha256_gadget, core=jax_core, symbol=jax_symbol,
    tags=jax_tags,
    store=lambda: jax_core.Store(jax_fields.BN256_SCALAR, use_device=False))

EMPTY_ROOTS = [
    0x1ca5b207085f3f0f324a2e0704b18fff1cda2e2d686aa85343fea91df77bf35b,
    0x0637ddaef5cd53ba6711c328952208d846222066701e10c34d3a6df7350de8aa,
    0x08127a45502f5939273edd1957c8748ae39992e2a459d99f999992a842df99a5,
    0x12c2ef2ab5df25442fe23d8711bf985f02c39e83930517f7103d4bd4228c6cfb,
]


def synthesizer(m):
    """A synthesizer of package ``m`` over a fresh store, every
    constraint checked as it is added."""
    cs = m.cs.ConstraintSystem(m.fields.BN256_SCALAR, check=True)
    ctx = m.circuit.SynthesisCtx(cs=cs, store=m.store(), slots={},
                                 blank=False, hint_bindings={},
                                 cproc_synthesizers={})
    return m.circuit.Synthesizer(ctx)


def _z(synth, ptr):
    z = synth.store.hash_ptr(ptr)
    return (z.tag, z.digest)


def _a(aptr):
    return (aptr.tag.value, aptr.hash.value)


# The gadget cases of tests/test_coproc_gadgets.py: each returns the
# values it checked, to be held against the other package's.

def case_construct_cons(m, synth):
    s = synth.store
    a, b = s.num(1), s.num(2)
    out = m.g.construct_cons(synth, synth.const_for_ptr(a),
                             synth.const_for_ptr(b))
    assert _a(out) == _z(synth, s.cons(a, b))
    return [_a(out)]


def case_construct_list(m, synth):
    s = synth.store
    elts = [s.num(i) for i in range(3)]
    out = m.g.construct_list(synth, [synth.const_for_ptr(e) for e in elts])
    assert _a(out) == _z(synth, s.list(elts))
    return [_a(out)]


def case_deconstruct_tuple2(m, synth):
    s = synth.store
    a, b = s.num(7), s.num(8)
    img = synth.const_for_ptr(s.cons(a, b))
    ca, cb = m.g.deconstruct_tuple2(synth, m.r1cs.Bool.true(), img, (a, b))
    assert (ca.hash.value, cb.hash.value) == (7, 8)
    return [_a(ca), _a(cb)]


def case_deconstruct_tuple3(m, synth):
    s = synth.store
    a, b, c = s.num(7), s.num(8), s.num(9)
    t3 = s.intern_tuple3([a, b, c], m.tags.ExprTag.Cproc)
    img = synth.const_for_ptr(t3)
    true = m.r1cs.Bool.true()
    out = m.g.deconstruct_tuple3(synth, true, img, (a, b, c))
    assert [p.hash.value for p in out] == [7, 8, 9]
    # wrong advice under a true premise is not satisfiable
    with pytest.raises(m.cs.SynthesisError):
        m.g.deconstruct_tuple3(synth, true, img, (a, b, a))
    return [_a(p) for p in out]


def case_car_cdr(m, synth):
    s = synth.store
    true = m.r1cs.Bool.true()
    nil, empty = s.intern_nil(), s.intern_string("")
    one = s.num_u64(1)
    cons = s.cons(one, one)
    abc = s.intern_string("abc")
    want = {nil: (nil, nil, False), cons: (one, one, True),
            empty: (nil, empty, False),
            abc: (s.char("a"), s.intern_string("bc"), True)}
    got = []
    for data, (car_w, cdr_w, not_empty_w) in want.items():
        car, cdr, not_empty = m.g.car_cdr(
            synth, true, synth.const_for_ptr(data), data)
        assert (_a(car), _a(cdr), not_empty.value) == \
            (_z(synth, car_w), _z(synth, cdr_w), not_empty_w)
        got.append((_a(car), _a(cdr), not_empty.value))
    return got


def case_car_cdr_simple(m, synth):
    s = synth.store
    true = m.r1cs.Bool.true()
    nil = s.intern_nil()
    one, two = s.num_u64(1), s.num_u64(2)
    cons = s.cons(one, two)
    car, cdr, not_nil = m.g.car_cdr_simple(
        synth, true, synth.const_for_ptr(cons), cons)
    assert (_a(car), _a(cdr), not_nil.value) == \
        (_z(synth, one), _z(synth, two), True)
    car2, _, not_nil2 = m.g.car_cdr_simple(
        synth, true, synth.const_for_ptr(nil), nil)
    assert (_a(car2), not_nil2.value) == (_z(synth, nil), False)
    return [_a(car), _a(cdr), not_nil.value, _a(car2), not_nil2.value]


def case_chain_car_cdr(m, synth):
    s = synth.store
    true = m.r1cs.Bool.true()
    nil = s.intern_nil()
    ab = s.intern_string("ab")
    cars, cdr, length = m.g.chain_car_cdr(
        synth, true, synth.const_for_ptr(ab), ab, 4)
    assert [_a(c) for c in cars] == [
        _z(synth, p) for p in (s.char("a"), s.char("b"), nil, nil)]
    assert _a(cdr) == _z(synth, s.intern_string("")) and length.value == 2
    lst = s.list([ab, ab])
    cars2, cdr2, length2 = m.g.chain_car_cdr(
        synth, true, synth.const_for_ptr(lst), lst, 3, simple=True)
    assert _a(cars2[0]) == _a(cars2[1]) == _z(synth, ab)
    assert _a(cdr2) == _z(synth, nil) and length2.value == 2
    return [[_a(c) for c in cars], _a(cdr), length.value,
            [_a(c) for c in cars2], _a(cdr2), length2.value]


GADGET_CASES = [case_construct_cons, case_construct_list,
                case_deconstruct_tuple2, case_deconstruct_tuple3,
                case_car_cdr, case_car_cdr_simple, case_chain_car_cdr]


@pytest.mark.parametrize("case", GADGET_CASES,
                         ids=[c.__name__[5:] for c in GADGET_CASES])
def test_gadget_matches_jax(case):
    out = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        synth = synthesizer(m)
        values = case(m, synth)
        assert synth.cs.is_satisfied()
        out[name] = (values, synth.cs.num_constraints, len(synth.cs.aux))
    assert out["port"] == out["jax"]


def _const_bits_be(m, data: bytes):
    return [m.r1cs.Bool(None, const_val=bool((byte >> i) & 1))
            for byte in data for i in range(7, -1, -1)]


MESSAGES = [b"", b"abc", b"a" * 64, b"xyz" * 40]


def sha256_run(m, msg: bytes):
    """Package ``m``'s sha256 gadget on ``msg`` (constant bits), every
    constraint checked as it is added: the digest, the counts, the
    shape digest and the witness."""
    cs = m.cs.ConstraintSystem(m.fields.BN256_SCALAR, check=True)
    digest = 0
    for b in m.sha256_gadget.sha256_bits(cs, _const_bits_be(m, msg)):
        digest = (digest << 1) | int(b.value)
    return (digest, cs.num_constraints, cs.num_aux, cs.shape_digest(),
            list(cs.aux))


def test_sha256_evaluate_matches_jax():
    """The coprocessor's result on two arguments (a number and a cons)
    and on one: the same z-pointer in both packages."""
    got = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        store = m.store()
        a = store.num(5)
        b = store.cons(store.num(1), store.intern_string("ab"))
        outs = [m.sha256.sha256_evaluate(store, args)
                for args in ([a, b], [a])]
        got[name] = [tuple(store.hash_ptr(o)) for o in outs]
        assert outs[1].tag == m.tags.ExprTag.Num
        z = store.hash_ptr(a)
        want = (hashlib.sha256(bytes(reversed(
            int(z.tag).to_bytes(32, "little")
            + z.digest.to_bytes(32, "little")))).digest())
        assert store.fetch_num(outs[1]) == int.from_bytes(want, "big") & \
            ((1 << (store.field.num_bits - 1)) - 1)
    assert got["port"] == got["jax"]


def test_nivc_sha256_frame_has_the_jax_shape():
    """The pc-1 circuit of a Lang with ``sha256_nivc_1``: the frame of
    ``(sha256_nivc_1 1)`` that runs it synthesizes to the JAX package's
    counts and shape digest (pinned), every constraint checked as it is
    added; the program's frames run pcs [0, 0, 1, 0]."""
    store = PORT.store()
    lang = ev.Lang()
    sym = sha256.sha256_nivc_symbol(1)
    lang.add_coprocessor(sym, sha256.sha256_coprocessor(1))
    func = make_cprocs_funcs(tuple(lang.cproc_specs()))[0]
    frames = ev.evaluate(ev.LangSetup.nivc(lang),
                         store.list([store.intern_symbol(sym), store.num(1)]),
                         store, 100)
    assert [f.pc for f in frames] == [0, 0, 1, 0]
    cs = cs_mod.ConstraintSystem(fields.BN256_SCALAR, check=True)
    circuit.synthesize_frame(cs, func, store, frames[2],
                             cproc_synthesizers=lang.circuit_synthesizers())
    assert (cs.num_constraints, cs.num_aux, cs.shape_digest()) == (
        100_305, 61_110,
        "21232255bfa8eb7d75470998a37fc0f1979bfbf81378674204731c9a59702ff4")


def test_trie_empty_roots_pinned():
    """Reference anchors: trie/mod.rs:925-1010 (bn256, arity 8)."""
    t = trie.Trie(PORT.store())
    assert t.empty_root_for_height(0) == 0
    assert [t.empty_root_for_height(h) for h in (1, 2, 3, 4)] == EMPTY_ROOTS
    assert t.root == t.empty_roots[trie.HEIGHT - 1]


def trie_run(m):
    """The same inserts (keys and values from a seeded generator, one
    key overwritten) in package ``m``'s trie: the roots, the lookups
    and one inclusion path."""
    rng = np.random.default_rng(11)
    keys = [int(k) for k in rng.integers(0, 1 << 62, 2)] + [1 << 200]
    vals = [int(v) for v in rng.integers(1, 1 << 62, 3)]
    t = m.trie.Trie(m.store())
    roots = []
    for k, v in zip(keys, vals):
        assert t.insert(k, v)
        roots.append(t.root)
    assert not t.insert(keys[0], vals[0])
    t.insert(keys[0], 42)
    reopened = m.trie.Trie(t.store, t.root)
    looked = [reopened.lookup(k) for k in keys + [keys[1] + 1]]
    assert looked == [42] + vals[1:] + [None]
    return roots, t.root, looked, t.prove_lookup(keys[2])


def test_trie_program_evaluates_to_the_reference_result():
    """The port's copy of ``TRIE_CODE`` (the reference's trie_nivc.rs)
    under the NIVC ``LangSetup``: 1,590 frames, 5 of them coprocessor
    frames, and the reference's pinned result."""
    assert TRIE_PROGRAM == TRIE_CODE
    store = PORT.store()
    lang, *_ = trie.install_trie_lang()
    assert len(lang.circuit_synthesizers()) == 3
    frames = ev.evaluate(ev.LangSetup.nivc(lang),
                         read_with_default_state(store, TRIE_PROGRAM), store,
                         1_000_000)
    assert len(frames) == 1590
    assert sorted(f.pc for f in frames if f.pc) == [1, 2, 2, 3, 3]
    assert frames[-1].output[2].tag == tags.ContTag.Terminal
    assert store.fetch_num(frames[-1].output[0]) == TRIE_RESULT == \
        12688603180


class _ShimCtx:
    blank = False


class _ShimSynth:
    """Just enough of a synthesizer for a trie circuit: ``cs``,
    ``store`` and ``ctx.blank`` (as in ``tests/test_trie_circuit.py``)."""

    def __init__(self, cs, store, blank=False):
        self.cs = cs
        self.store = store
        self.ctx = _ShimCtx()
        self.ctx.blank = blank


def _ptr(m, cs, tag, value):
    return m.circuit.AllocatedPtr(m.r1cs.Num.constant(cs, int(tag)),
                                  m.r1cs.alloc_num(cs, value))


def synthesize_trie(m, circ, store, not_dummy, values, blank=False):
    """``circ`` synthesized on Num inputs ``values`` (and an env and a
    continuation passed through) in a fresh system of package ``m``."""
    cs = m.cs.ConstraintSystem(m.fields.BN256_SCALAR)
    nd = m.r1cs.alloc_bit(cs, not_dummy)
    env = _ptr(m, cs, m.tags.ExprTag.Env, 0)
    cont = _ptr(m, cs, 0x1000, 0)
    ins = [_ptr(m, cs, m.tags.ExprTag.Num, v) for v in values]
    out = circ.synthesize(_ShimSynth(cs, store, blank), nd,
                          ins + [env, cont])
    assert out[1] is env and out[2] is cont
    return cs, out[0]


@pytest.mark.parametrize("name,arity,counts", [
    ("NewCircuit", 0, (1, 3, "3a4fa33e02b7d41848ce2ddc1ec0c7847b180e9b958d"
                              "1792cad9fd0834e89123")),
    ("LookupCircuit", 2, (33_931, 34_529, "6ee321fd6e31bef52fd319fff456af1"
                                          "76fcadaa25d57675fcbdd677d26c96c37")),
    ("InsertCircuit", 3, (68_854, 69_453, "630f47e9a388aca89e522623369aa86"
                                          "2b9d52b774bb35a3adc613a7b0ee297bb")),
])
def test_blank_trie_circuit_has_the_jax_shape(name, arity, counts):
    """Full height, blank mode (not_dummy false, every input 0): the JAX
    package's counts and shape digest."""
    cs, _ = synthesize_trie(PORT, getattr(trie, name)(), PORT.store(),
                            False, [0] * arity, blank=True)
    assert (cs.num_constraints, cs.num_aux, cs.shape_digest()) == counts


TRIE_CASES = ["lookup", "lookup missing", "insert", "dummy"]


def trie_witness_run(m, which: str):
    """A trie of 3 entries (keys and values from a seeded generator) in
    a fresh store of package ``m``, whose trie ``HEIGHT`` the caller has
    set to 4 (keys below 8^4), and one circuit synthesized on it: its
    inputs, witness, constraint count, shape digest and output. The
    output is the host trie's and every constraint holds."""
    rng = np.random.default_rng(7)
    keys = [int(k) for k in rng.choice(8 ** 4, 4, replace=False)]
    vals = [int(v) for v in rng.integers(1, 1 << 60, 3)]
    store = m.store()
    t = m.trie.Trie(store)
    for k, v in zip(keys, vals):
        t.insert(k, v)
    want = None
    if which == "insert":
        inputs, circ = [t.root, keys[3], 777], m.trie.InsertCircuit()
        after = m.trie.Trie(store, t.root)
        after.insert(keys[3], 777)
        want = after.root
    elif which == "dummy":
        inputs, circ = [31337, 911, 5], m.trie.InsertCircuit()
    else:
        key = keys[3] if which == "lookup missing" else keys[1]
        inputs, circ = [t.root, key], m.trie.LookupCircuit()
        want = 0 if which == "lookup missing" else vals[1]
    cs, out = synthesize_trie(m, circ, store, which != "dummy", inputs)
    assert cs.is_satisfied()
    assert want is None or out.hash.value == want
    return (list(cs.inputs), list(cs.aux), cs.num_constraints,
            cs.shape_digest(), _a(out))


# The JAX side of the slowest comparisons (its sha256 gadget on the 4
# messages, its trie's inserts and its trie circuits at height 4) runs
# in a child process, started when the module starts, while the tests
# above run here.
JAX_CHILD = r'''
import pickle, sys
import test_torch_coproc as t
if sys.argv[2] == "sha256":
    out = [t.sha256_run(t.JAX, msg) for msg in t.MESSAGES]
else:
    out = dict(trie=t.trie_run(t.JAX))
    t.JAX.trie.HEIGHT = 4
    out["witness"] = [t.trie_witness_run(t.JAX, w) for w in t.TRIE_CASES]
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module", autouse=True)
def jax_children(tmp_path_factory):
    """Two JAX children, one for the sha256 gadget and one for the trie,
    started when the module starts."""
    path = tmp_path_factory.mktemp("jax_coproc")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    children = {part: subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(path / part), part],
        cwd=ROOT, env=env) for part in ("sha256", "trie")}
    yield children, path
    for child in children.values():
        child.kill()
        child.wait()


def jax_result(jax_children, part: str):
    children, path = jax_children
    assert children[part].wait() == 0
    with open(path / part, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("k", range(len(MESSAGES)),
                         ids=["empty", "abc", "a64", "xyz40"])
def test_sha256_gadget_matches_hashlib_and_jax(jax_children, k):
    msg = MESSAGES[k]
    got = sha256_run(PORT, msg)
    assert got[0] == int.from_bytes(hashlib.sha256(msg).digest(), "big")
    assert got == jax_result(jax_children, "sha256")[k]


def test_trie_insert_and_lookup_match_jax(jax_children):
    assert trie_run(PORT) == jax_result(jax_children, "trie")["trie"]


@pytest.mark.parametrize("k", range(len(TRIE_CASES)),
                         ids=[w.replace(" ", "_") for w in TRIE_CASES])
def test_concrete_trie_witness_matches_jax(jax_children, monkeypatch, k):
    monkeypatch.setattr(trie, "HEIGHT", 4)
    got = trie_witness_run(PORT, TRIE_CASES[k])
    assert got == jax_result(jax_children, "trie")["witness"][k]
    assert got[2] == (1_936 if k < 2 else 3_580)
