"""The port's Foil and Coil (``lurk_tpu_torch.foil``) against the JAX
package's on the CPU: the cases of ``tests/test_foil.py``, each built in
both packages. Integers and labels only: tolerance 0.

- After ``minimize`` / ``finalize``, the vertices, ``classes``,
  ``canonical_graph`` and (for Coil) ``class_info`` equal the JAX ones,
  and each case's own expectation holds.
- ``Coil.synthesize`` and a ``MappedFoil`` with a custom relation give
  the JAX constraints (the same matrices) and witness, satisfied under
  the same valuation and unsatisfied under a changed one.
- Source the JAX package asserts on (an improper list, a ``let`` with
  an empty body) raises ``ValueError``.
"""

import pytest

import lurk_tpu.foil as jfoil
import lurk_tpu.r1cs.cs as jcs
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.poseidon.host import hash_preimage as jax_hash
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch import foil
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.poseidon.host import hash_preimage
from lurk_tpu_torch.r1cs import cs as pcs
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

# (foil module, r1cs.cs module, field, store maker, reader) of each package
PORT = (foil, pcs, BN256_SCALAR, lambda: Store(BN256_SCALAR, device="cpu"),
        read_with_default_state)
JAX = (jfoil, jcs, JAX_BN256, lambda: JaxStore(JAX_BN256, use_device=False),
       jax_read)

COIL_PROGRAM = """(let ((x (cons q r)))
                    (let ((s (let ((x (cons a b)))
                               (car x)
                               (xxx qqq))))
                      (car x)))"""


def head_name(v):
    return v.head[0] if isinstance(v.head, tuple) else v.head


def views(f):
    return ([(v.head, v.successors, v.meta) for v in f.verts], f.classes(),
            f.canonical_graph())


def congruent(pkg):
    f = pkg[0].Foil()
    a, b = f.add("a"), f.add("b")
    p1, p2 = f.add("+", [a, b]), f.add("+", [a, b])
    f.minimize()
    assert f.find(p1) == f.find(p2) and f.find(a) != f.find(b)
    return f


def upward(pkg):
    f = pkg[0].Foil()
    a, b = f.add("a"), f.add("b")
    fa, fb = f.add("f", [a]), f.add("f", [b])
    ffa, ffb = f.add("f", [fa]), f.add("f", [fb])
    f.assert_eq(a, b)
    f.minimize()
    assert f.find(fa) == f.find(fb) and f.find(ffa) == f.find(ffb)
    assert len(f.canonical_graph()) == 3
    return f


def no_false_merges(pkg):
    f = pkg[0].Foil()
    a = f.add("a")
    g1, h1 = f.add("g", [a]), f.add("h", [a])
    f.minimize()
    assert f.find(g1) != f.find(h1)
    return f


def pair_schema(m, metadata=True):
    meta = (lambda *k: k) if metadata else (lambda *k: None)
    pair = m.Func.constructor(
        "pair", [m.Func("fst", metadata=meta("proj", "pair", 0)),
                 m.Func("snd", metadata=meta("proj", "pair", 1))],
        metadata=("sum", 2))
    schema = m.Schema(equivalences=[m.Func("bind")] if metadata else [])
    schema.add_constructor(pair)
    return schema


def schema_deduction(pkg):
    """A projection deduces its sibling and its defining constructor;
    injectivity puts snd(x) in b's class."""
    m = pkg[0]
    schema = pair_schema(m)
    assert schema.constructor_for_projector("snd")[1] == 1
    f = m.Foil(schema)
    a, b, x = f.add(("var", "a")), f.add(("var", "b")), f.add(("var", "x"))
    f.add(("fst",), [x], meta=("proj", "pair", 0))
    p = f.add(("pair",), [a, b], meta=("sum", 2))
    f.add(("bind",), [x, p])
    f.finalize()
    snd = [i for i, v in enumerate(f.verts) if head_name(v) == "snd"]
    assert f.find(x) == f.find(p) and snd and f.find(snd[0]) == f.find(b)
    return f


def schema_injectivity(pkg):
    f = pkg[0].Foil(pair_schema(pkg[0], metadata=False))
    a, b, c, d = (f.add(("var", n)) for n in "abcd")
    p1, p2 = f.add(("pair",), [a, b]), f.add(("pair",), [c, d])
    f.assert_eq(p1, p2)
    f.finalize()
    assert f.find(a) == f.find(c) and f.find(b) == f.find(d)
    return f


GRAPHS = {f.__name__: f for f in (congruent, upward, no_false_merges,
                                   schema_deduction, schema_injectivity)}


@pytest.mark.parametrize("case", GRAPHS)
def test_foil_graphs_match_jax(case):
    assert views(GRAPHS[case](PORT)) == views(GRAPHS[case](JAX))


def coil_of(pkg, src):
    store = pkg[3]()
    coil = pkg[0].Coil()
    coil.add_program(store, pkg[4](store, src))
    return coil


def test_coil_program_matches_jax():
    """coil.rs:603-717 test_coil_foil: 16 singleton classes before
    finalization; after it, the JAX classes, canonical graph and
    class_info, with x merged into its defining cons(q, r) and car(x)
    into q."""
    coil, jcoil = coil_of(PORT, COIL_PROGRAM), coil_of(JAX, COIL_PROGRAM)
    f = coil.foil
    assert len(f.verts) == len(f.classes()) == 16
    assert views(f) == views(jcoil.foil)
    coil.finalize()
    jcoil.finalize()
    assert views(f) == views(jcoil.foil)
    assert coil.class_info() == jcoil.class_info()
    outer_x = [f.find(i) for i, v in enumerate(f.verts)
               if head_name(v) == "var" and v.head[1].endswith(".x")
               and v.head[2] == 2]
    q = f.find(0)
    cars = [i for i, v in enumerate(f.verts) if head_name(v) == ".lurk.car"
            and f.find(v.successors[0]) == outer_x[0]]
    assert cars and all(f.find(i) == q for i in cars)


def coil_valuation(coil, hash_fn, field):
    """tests/test_foil.py's valuation: q = 7, r = 9, every class with two
    successors hash2(q, r), the rest 0."""
    f = coil.foil
    values = {f.find(0): 7, f.find(1): 9}
    digest = hash_fn(field, [7, 9])
    for rep, (_, succ) in f.canonical_graph().items():
        values.setdefault(rep, digest if succ and len(succ) == 2 else 0)
    return values


def synthesize(pkg, build, values, check):
    cs = pkg[1].ConstraintSystem(pkg[2], check=check)
    build(pkg).synthesize(cs, values)
    return cs


def coil_circuit(pkg):
    coil = coil_of(pkg, "(let ((x (cons q r))) (car x))")
    coil.finalize()
    return coil


def sum_mapped(pkg):
    """schema_deduction's graph mapped through a relation head = fst +
    snd on its pair class."""
    cs_mod = pkg[1]

    class SumRelation(pkg[0].Relation):
        def synthesize(self, cs, allocated_head, successors):
            lc = {}
            for s in successors:
                lc = cs_mod.lc_add(lc, s.lc, cs.p)
            cs.enforce(lc, {cs_mod.ConstraintSystem.ONE_VAR: 1},
                       allocated_head.lc)
    f = schema_deduction(pkg)
    return pkg[0].MappedFoil(f, pkg[0].MetaMapper({("sum", 2): SumRelation()}))


def sum_valuation(f):
    return {f.find(0): 7, f.find(1): 9, f.find(4): 16}


@pytest.mark.parametrize("case", ["coil", "mapped"])
def test_circuits_match_jax(case):
    """The same constraints, witness and satisfaction as the JAX
    circuit; a changed valuation is unsatisfied in both."""
    if case == "coil":
        build = coil_circuit
        values = coil_valuation(coil_circuit(JAX), jax_hash, JAX_BN256)
        assert values == coil_valuation(coil_circuit(PORT), hash_preimage,
                                        BN256_SCALAR)
        bad = {**values, coil_circuit(PORT).foil.find(0): 8}
    else:
        build = sum_mapped
        values = sum_valuation(sum_mapped(PORT).foil)
        bad = {**values, sum_mapped(PORT).foil.find(4): 17}
    cs = synthesize(PORT, build, values, check=True)
    jcs_ = synthesize(JAX, build, values, check=True)
    assert cs.is_satisfied() and jcs_.is_satisfied()
    assert len(cs.constraints) > 0
    assert cs.constraints == jcs_.constraints
    assert cs.aux == jcs_.aux
    assert cs.shape_digest() == jcs_.shape_digest()
    assert not synthesize(PORT, build, bad, check=False).is_satisfied()
    assert not synthesize(JAX, build, bad, check=False).is_satisfied()


@pytest.mark.parametrize("src, what", [
    ("(f a . b)", "improper list"),
    ("(let ((x 1)))", "empty body"),
])
def test_coil_rejects_bad_source(src, what):
    with pytest.raises(ValueError, match=what):
        coil_of(PORT, src)
