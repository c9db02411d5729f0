"""The port's memoset coroutines (``lurk_tpu_torch.coroutine``: the
Scope, the coroutine circuits, the env and Toplevel queries) against the
JAX package on the CPU. Integers only: tolerance 0.

- Five scopes built alike in both packages (the demo factorial, once
  alone at rc = 1 and once reused at rc = 3; the eight env lookups of
  ``tests/test_memoset_env.py`` and its two-hop case at rc = 2; the
  toplevel factorial at rc = 3 and even/odd at rc = 2): the results, the
  memo table, every provenance digest, the unique keys per index in
  order, the removal counts, the transcript's digest and ``r``,
  ``init_memoset``, the initial transcript and the LogUp balance.
- ``CoroutineCircuit`` for the demo, env and toplevel queries at rc = 1
  and 3: the constraint and aux counts, the shape digest, the inputs and
  the witness equal the JAX circuit's, the system is satisfied, and the
  dummy-only circuit has the same shape.
- ``lem/circuit``'s ``Op::Crout`` branch: a Func with a crout
  synthesizes the JAX constraints through its handler; without a
  handler both packages raise ``SynthesisError``.
- ``SnCyclePublicParams.setup`` without a ``cache_base`` synthesizes the
  shapes a disk-cached setup gives; ``base_allowed`` drops the base-case
  constraint of circuits above 0 only.
- The cycle prover's in-memory parameters are keyed by the circuits:
  two toplevels of one size get different keys.
- Where the JAX package asserts, the port raises.

The JAX side hashes and traces Poseidon on its Python path (its C++ is
not compiled here).
"""

import types

import pytest

import lurk_tpu.coproc.gadgets as jax_gadgets
import lurk_tpu.coroutine.circuit as jax_circuit
import lurk_tpu.coroutine.env as jax_env
import lurk_tpu.coroutine.memoset as jax_memoset
import lurk_tpu.coroutine.toplevel as jax_toplevel
import lurk_tpu.lem.circuit as jax_lem_circuit
import lurk_tpu.lem.interpreter as jax_interpreter
import lurk_tpu.lem.slots as jax_slots
import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.r1cs.cs as jax_cs
import lurk_tpu.r1cs.gadgets as jax_r1cs_gadgets
import lurk_tpu.store.core as jax_core
import lurk_tpu.symbol as jax_symbol
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu_torch.coproc import gadgets
from lurk_tpu_torch.coroutine import circuit, env, memoset, prove, toplevel
from lurk_tpu_torch.coroutine.prove_cycle import MemosetCycleProver
from lurk_tpu_torch.examples import sample_toplevel
from lurk_tpu_torch.fields import BN256_SCALAR, PALLAS_SCALAR
from lurk_tpu_torch.lem import circuit as lem_circuit
from lurk_tpu_torch.lem import interpreter, ir, slots
from lurk_tpu_torch.lem.eval_step import lit_num
from lurk_tpu_torch.proof import nova, supernova_cycle
from lurk_tpu_torch.r1cs import cs as cs_mod
from lurk_tpu_torch.r1cs import gadgets as r1cs_gadgets
from lurk_tpu_torch.store import core
from lurk_tpu_torch.symbol import Symbol, user_sym
from test_toplevel import _sample_toplevel as jax_sample_toplevel
from test_torch_field import one_torch_thread  # noqa: F401

PORT = types.SimpleNamespace(
    memoset=memoset, circuit=circuit, env=env, toplevel=toplevel,
    lem=lem_circuit, interpreter=interpreter, slots=slots, cs=cs_mod,
    gadgets=r1cs_gadgets, coproc=gadgets,
    Symbol=Symbol, sample=sample_toplevel, field=BN256_SCALAR,
    store=lambda: core.Store(BN256_SCALAR, device="cpu"))
JAX = types.SimpleNamespace(
    memoset=jax_memoset, circuit=jax_circuit, env=jax_env,
    toplevel=jax_toplevel, lem=jax_lem_circuit, interpreter=jax_interpreter,
    slots=jax_slots, cs=jax_cs, gadgets=jax_r1cs_gadgets,
    coproc=jax_gadgets, Symbol=jax_symbol.Symbol,
    sample=jax_sample_toplevel, field=JAX_BN256,
    store=lambda: jax_core.Store(JAX_BN256, use_device=False))


@pytest.fixture(scope="module", autouse=True)
def jax_python_poseidon():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_poseidon, "available", lambda: False)
        yield


# ---------------------------------------------------------------------------
# Scopes, built alike in both packages
# ---------------------------------------------------------------------------


def demo(pkg, s, nums, rc):
    scope = pkg.memoset.Scope(s, pkg.memoset.DemoQuery, default_rc=rc)
    results = [scope.query(pkg.memoset.DemoQuery(s.num(n)).to_ptr(s))
               for n in nums]
    return scope, results


def env_setup(pkg, s):
    a, b, c = (s.intern_symbol(pkg.Symbol(("lurk", "user", n), False))
               for n in "abc")
    one, two, three, four = (s.num(i) for i in (1, 2, 3, 4))
    empty = s.intern_empty_env()
    a_env = s.push_binding(a, one, empty)
    b_env = s.push_binding(b, two, a_env)
    c_env = s.push_binding(c, three, b_env)
    a2_env = s.push_binding(a, four, c_env)
    return (a, b, c), (one, two, three, four), \
        (empty, a_env, b_env, c_env, a2_env)


def env_cases(pkg, s):
    """test_memoset_env.py's eight lookups (env.rs:239-280), then its
    two-hop case: [(var, env, value found or None)]."""
    (a, b, c), (one, two, three, four), \
        (empty, a_env, b_env, c_env, a2_env) = env_setup(pkg, s)
    return [(a, empty, None), (a, a_env, one), (b, a_env, None),
            (b, b_env, two), (a, a2_env, four), (c, b_env, None),
            (c, c_env, three), (c, a2_env, three), (b, empty, None)]


def env_lookups(pkg, s, rc):
    scope = pkg.memoset.Scope(s, pkg.env.EnvQuery, default_rc=rc)
    results = []
    for var, e, found in env_cases(pkg, s):
        got = scope.query(pkg.env.EnvQuery(var, e).to_ptr(s))
        nil = s.intern_nil()
        assert got == (s.cons(found, s.intern_t()) if found is not None
                       else s.cons(nil, nil))
        results.append(got)
    return scope, results


def toplevel_queries(pkg, s, calls, rc):
    tl, factorial, even, odd = pkg.sample()
    names = dict(factorial=factorial, even=even, odd=odd)
    scope = pkg.toplevel.scope_for(tl, s, default_rc=rc)
    q = scope.query_cls
    results = [scope.query(q(names[f], [s.num(n)]).to_ptr(s))
               for f, n in calls]
    return scope, results


SCOPES = {
    "demo-5": (lambda pkg, s: demo(pkg, s, [5], 1), [120]),
    "demo-4-6": (lambda pkg, s: demo(pkg, s, [4, 6], 3), [24, 720]),
    "env": (lambda pkg, s: env_lookups(pkg, s, 2), None),
    "toplevel-factorial": (
        lambda pkg, s: toplevel_queries(pkg, s, [("factorial", 5)], 3),
        [120]),
    "toplevel-even-odd": (
        lambda pkg, s: toplevel_queries(
            pkg, s, [("even", 4), ("odd", 5), ("factorial", 3)], 2),
        [1, 1, 6]),
}


def summary(scope, results) -> dict:
    """A finalized scope as plain ints, its pointers by their digests."""
    s = scope.store

    def z(ptr):
        zp = s.hash_ptr(ptr)
        return int(zp.tag), zp.digest
    return dict(
        results=[z(r) for r in results],
        queries={z(k): z(v) for k, v in scope.queries.items()},
        provenances={z(k): z(v) for k, v in scope._provenances.items()},
        unique=[(i, [z(k) for k in keys])
                for i, keys in sorted(scope.unique_inserted_keys.items())],
        removals={z(k): c for k, c in scope._removal_counts.items()},
        multiset=sorted((z(kv), c) for kv, c in scope.multiset.items()),
        transcript=z(scope.transcript.acc), r=scope.r,
        init_memoset=scope.init_memoset(),
        init_transcript=z(scope.init_transcript_ptr()),
        balance=scope.verify_balance())


@pytest.fixture(scope="module")
def scopes():
    """Each scope of SCOPES, finalized in both packages."""
    out = {}
    for name, (build, _) in SCOPES.items():
        pair = {}
        for side, pkg in (("port", PORT), ("jax", JAX)):
            scope, results = build(pkg, pkg.store())
            scope.finalize_transcript()
            pair[side] = (scope, results)
        out[name] = pair
    return out


@pytest.mark.parametrize("name", SCOPES)
def test_scope_matches_jax(scopes, name):
    scope, results = scopes[name]["port"]
    expect = SCOPES[name][1]
    if expect is not None:
        assert [scope.store.fetch_num(r) for r in results] == expect
    got, want = summary(scope, results), summary(*scopes[name]["jax"])
    assert got["balance"] and want["balance"]
    for field in want:
        assert got[field] == want[field], field


def test_balance_breaks_on_a_forged_use(scopes):
    scope, _ = scopes["demo-4-6"]["port"]
    kv = next(iter(scope.multiset))
    scope.multiset[kv] += 1
    try:
        assert not scope.verify_balance()
    finally:
        scope.multiset[kv] -= 1
    assert scope.verify_balance()


def test_toplevel_coroutines_evaluate_as_jax():
    """test_toplevel.py's test_coroutine_eval: each coroutine's eval on
    one scope, memoized sub-queries shared across them."""
    out = {}
    for side, pkg in (("port", PORT), ("jax", JAX)):
        s = pkg.store()
        tl, factorial, even, odd = pkg.sample()
        scope = pkg.toplevel.scope_for(tl, s)
        q = scope.query_cls
        vals = [s.fetch_num(q(sym, [s.num(5)]).eval(scope))
                for sym in (factorial, even, odd)]
        out[side] = (vals, len(scope.queries), tl.index_of(odd))
        form = q(factorial, [s.num(7)]).to_ptr(s)
        back = q.from_ptr(s, form)
        assert back.name == factorial and s.fetch_num(back.args[0]) == 7
    assert out["port"] == out["jax"] == ([120, 0, 1], 15, 2)


# ---------------------------------------------------------------------------
# The coroutine circuits
# ---------------------------------------------------------------------------


def circuit_query(pkg, kind: str, index: int):
    if kind == "demo":
        return pkg.circuit.DemoCircuitQuery()
    if kind == "env":
        return pkg.env.EnvCircuitQuery()
    return pkg.toplevel.ToplevelCircuitQuery(pkg.sample()[0]).for_index(
        index)


def scope_of(kind: str, pkg, rc: int):
    s = pkg.store()
    if kind == "demo":
        scope, _ = demo(pkg, s, [5], rc)
    elif kind == "env":
        scope, _ = env_lookups(pkg, s, rc)
    else:
        scope, _ = toplevel_queries(
            pkg, s, [("factorial", 5), ("even", 4)], rc)
    scope.finalize_transcript()
    return scope


# (kind, circuit index, rc) -> the constraint count where it is pinned
CIRCUITS = {("demo", 0, 1): 2345, ("demo", 0, 3): 7011,
            ("env", 0, 1): None, ("env", 0, 3): None,
            ("toplevel", 0, 1): 1772, ("toplevel", 0, 3): 5292,
            ("toplevel", 1, 1): None, ("toplevel", 2, 3): None}


@pytest.mark.parametrize("kind,index,rc", CIRCUITS,
                         ids=[f"{k}-{i}-rc{rc}" for k, i, rc in CIRCUITS])
def test_coroutine_circuit_matches_jax(kind, index, rc):
    """The first chunk of the index's keys, z_in = the prover's z0 and
    z_out its host chaining, synthesized by both packages."""
    scope = scope_of(kind, PORT, rc)
    cq = circuit_query(PORT, kind, index)
    prover = prove.MemosetProver(rc, cq, device="cpu")
    step = next(st for st in prover.steps(scope) if st.index == index)
    z_in = prover.z0(scope)
    z_out, _ = prover.next_z(scope, step, z_in, scope.init_transcript_ptr())
    x, w, cs = step.instance(z_in, z_out)
    assert cs.is_satisfied()
    shape = nova.R1CSShape(cs)
    blank = circuit.CoroutineCircuit(scope, [], index, rc, cq)
    assert nova.R1CSShape(blank.instance(z_in, z_in)[2]).digest == \
        shape.digest

    jscope = scope_of(kind, JAX, rc)
    jstep = jax_circuit.CoroutineCircuit(
        jscope, jscope.unique_inserted_keys[index][:rc], index, rc,
        circuit_query(JAX, kind, index))
    jx, jw, jcs = jstep.instance(z_in, z_out)
    assert (cs.num_constraints, cs.num_aux, shape.digest) == \
        (jcs.num_constraints, jcs.num_aux, jcs.shape_digest())
    assert (x, w) == (jx, jw)
    if CIRCUITS[kind, index, rc] is not None:
        assert cs.num_constraints == CIRCUITS[kind, index, rc]


def blank_crout_synthesis(pkg, handler):
    """The blank synthesis of the toplevel's ``even`` Func, its
    ``Op::Crout`` through ``handler``: the constraint system."""
    s = pkg.store()
    tl, _, even, _ = pkg.sample()
    func = tl.get(even).func
    cs = pkg.cs.ConstraintSystem(pkg.field)
    frame = pkg.interpreter.Frame.blank_frame(func, 0, s)
    slot_allocs = {st: [pkg.lem.allocate_slot(cs, d, st, s)
                        for d in frame.hints.get(st)]
                   for st in pkg.slots.SLOT_TYPES}
    ctx = pkg.lem.SynthesisCtx(
        cs=cs, store=s, slots=slot_allocs, blank=True, hint_bindings={},
        cproc_synthesizers={}, crout_synthesizer=handler)
    args = [pkg.lem.alloc_ptr(cs, 0, 0) for _ in func.input_params]
    pkg.lem.Synthesizer(ctx).synthesize_func(
        func, args, pkg.gadgets.alloc_bit(cs, True), pkg.lem.SlotCounters(),
        frame.output)
    return cs


def cons_handler(pkg):
    """A crout handler that returns (sym . last argument), hashed."""
    def handler(synth, not_dummy, sym, arg_ptrs):
        head = synth.const_for_ptr(synth.store.intern_symbol(sym))
        return [pkg.coproc.construct_cons(synth, head, arg_ptrs[-1])]
    return handler


def test_crout_synthesizes_the_jax_constraints():
    cs = blank_crout_synthesis(PORT, cons_handler(PORT))
    jcs = blank_crout_synthesis(JAX, cons_handler(JAX))
    assert (cs.num_constraints, cs.num_aux, cs.shape_digest()) == \
        (jcs.num_constraints, jcs.num_aux, jcs.shape_digest())


def test_crout_without_a_handler_raises():
    for pkg in (PORT, JAX):
        with pytest.raises(pkg.cs.SynthesisError,
                           match="outside a memoset circuit scope"):
            blank_crout_synthesis(pkg, None)
    with pytest.raises(cs_mod.SynthesisError, match="gave 2 outputs"):
        blank_crout_synthesis(
            PORT, lambda synth, nd, sym, args: [args[0], args[0]])


# ---------------------------------------------------------------------------
# SnCyclePublicParams.setup: cache_base=None and base_allowed
# ---------------------------------------------------------------------------


def _step_add(cs, zi, aux):
    z_next = [r1cs_gadgets.add(cs, zi[0], r1cs_gadgets.Num.constant(cs, 1)),
              zi[1]]
    return z_next, r1cs_gadgets.alloc_num(cs, aux)


def _step_mul(cs, zi, aux):
    z_next = [zi[0], r1cs_gadgets.mul(cs, zi[1],
                                      r1cs_gadgets.Num.constant(cs, 3))]
    return z_next, r1cs_gadgets.alloc_num(cs, aux)


def test_cycle_setup_without_a_disk_cache(tmp_path, monkeypatch):
    """Two toy circuits (tests/test_supernova_cycle.py's): the shapes
    synthesized with no cache_base are the ones a disk-cached setup
    (every existing caller's route) writes and reads back; base_allowed
    takes away circuit 1's base-case constraint and touches circuit 0
    and the secondary not at all. The keys are left out."""
    monkeypatch.setenv("LURK_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(nova.CommitmentKey, "setup",
                        staticmethod(lambda *args, **kw: None))

    def shapes(**kw):
        pp = supernova_cycle.SnCyclePublicParams.setup(
            PALLAS_SCALAR, 2, [_step_add, _step_mul], [0, 1], [0, 0],
            device="cpu", **kw)
        return [(s.digest, s.num_constraints)
                for s in pp.shapes1 + [pp.shape2]], pp.pp_digest

    plain = shapes()
    assert shapes(cache_base="toy") == plain          # written
    assert shapes(cache_base="toy") == plain          # read back
    free, _ = shapes(base_allowed=True)
    assert free[0] == plain[0][0] and free[2] == plain[0][2]
    assert free[1][1] == plain[0][1][1] - 1


# ---------------------------------------------------------------------------
# The departures: the parameter key, and raises for asserts
# ---------------------------------------------------------------------------


def other_toplevel():
    """A toplevel of sample_toplevel's size and names whose ``odd``
    returns 1 at 0."""
    tl, factorial, even, odd = sample_toplevel()
    odd_one = ir.Func("odd", ("n",), 1, ir.block(lit_num("one", 1),
                                                 ir.ret("one")))
    return toplevel.Toplevel([(factorial, tl.get(factorial).func),
                              (even, tl.get(even).func), (odd, odd_one)])


def test_cycle_parameters_are_keyed_by_the_circuits():
    def key(cq, rc=2):
        return MemosetCycleProver(rc, cq, device="cpu").params_key(
            BN256_SCALAR, 3)
    tl = sample_toplevel()[0]
    same = key(toplevel.ToplevelCircuitQuery(tl))
    assert key(toplevel.ToplevelCircuitQuery(sample_toplevel()[0])) == same
    assert key(toplevel.ToplevelCircuitQuery(tl).for_index(1)) == same
    assert key(toplevel.ToplevelCircuitQuery(other_toplevel())) != same
    assert key(toplevel.ToplevelCircuitQuery(tl), rc=1) != same
    assert key(circuit.DemoCircuitQuery()) != key(env.EnvCircuitQuery())


def test_caller_faults_raise_value_errors(scopes):
    s = PORT.store()
    with pytest.raises(ValueError, match="transcript must be non-empty"):
        memoset.Transcript(s).r()
    scope = memoset.Scope(s, memoset.DemoQuery)
    with pytest.raises(ValueError, match="invalid query"):
        scope.query(s.num(3))
    bad = memoset.DemoQuery(s.intern_nil()).to_ptr(s)
    with pytest.raises(ValueError, match="non-number"):
        scope.query(bad)
    with pytest.raises(ValueError, match="scope rc must match"):
        prove.MemosetProver(2, circuit.DemoCircuitQuery(),
                            device="cpu").steps(scopes["demo-5"]["port"][0])
    with pytest.raises(ValueError, match="at least one element"):
        toplevel.to_improper_list(s, [])
    nullary = toplevel.make_query_cls(toplevel.Toplevel([(
        user_sym("zero"), ir.Func("zero", (), 1, ir.block(
            lit_num("z", 0), ir.ret("z"))))]))
    with pytest.raises(ValueError, match="0 argument"):
        nullary.from_ptr(s, s.cons(s.intern_symbol(user_sym("zero")),
                                   s.intern_nil()))


def test_cyclic_queries_raise(scopes):
    scope, _ = scopes["demo-5"]["port"]
    s = scope.store
    a, b = (memoset.DemoQuery(s.num(n)) for n in (1, 0))
    cyclic = memoset.Scope(s, memoset.DemoQuery)
    cyclic.queries = {a.to_ptr(s): s.num(1), b.to_ptr(s): s.num(1)}
    cyclic._register_dependency(a, b)
    cyclic._register_dependency(b, a)
    with pytest.raises(ValueError, match="cyclic"):
        cyclic.compute_provenances()


def test_synthesis_faults_raise_synthesis_errors(scopes):
    scope, _ = scopes["toplevel-factorial"]["port"]
    tl = scope.query_cls.toplevel
    unbound = circuit.CoroutineCircuit(scope, [], 0, 1,
                                       toplevel.ToplevelCircuitQuery(tl))
    with pytest.raises(cs_mod.SynthesisError, match="for_index"):
        unbound.instance([0] * 12, [0] * 12)
    s = scope.store
    lookup = env.EnvQuery(s.intern_symbol(user_sym("x")),
                          s.intern_empty_env()).to_ptr(s)
    with pytest.raises(cs_mod.SynthesisError, match="not a coroutine"):
        circuit.CoroutineCircuit(
            scope, [lookup], 0, 1,
            toplevel.ToplevelCircuitQuery(tl).for_index(0)).instance(
                [0] * 12, [0] * 12)
    demo_key = memoset.DemoQuery(s.num(2)).to_ptr(s)
    with pytest.raises(cs_mod.SynthesisError, match="not a lookup"):
        circuit.CoroutineCircuit(
            scope, [demo_key], 0, 1, env.EnvCircuitQuery()).instance(
                [0] * 12, [0] * 12)
