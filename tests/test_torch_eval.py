"""The slice as a whole: read -> store -> LEM evaluate -> hydrate in the
port against the JAX package, at the main path's full size (fib(100),
800 frames), plus iteration counts pinned to the reference's
eval_tests.rs. Digests are exact."""

import pytest

from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem.evaluation import evaluate as jax_evaluate
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem.evaluation import evaluate
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.tags import ContTag

from test_torch_field import one_torch_thread  # noqa: F401
from test_torch_store import record_batches


def test_fib100_matches_jax_frame_by_frame(monkeypatch):
    batches = record_batches(monkeypatch)
    store = Store(BN256_SCALAR, device="cpu")
    frames = evaluate(None, read_with_default_state(store, FIB_PROGRAM),
                      store, fib_limit(100, 100))
    store.hydrate_z_cache()
    jstore = JaxStore(JAX_BN256, use_device=False)
    jframes = jax_evaluate(None, jax_read(jstore, FIB_PROGRAM), jstore,
                           fib_limit(100, 100))
    jstore.hydrate_z_cache()
    assert len(frames) == len(jframes) == 800
    # the batched (plain) path ran on fib(100)'s four waves >= 64
    assert batches == [(8, 114), (8, 344), (4, 123), (8, 226)]
    for f, g in zip(frames, jframes):
        assert [tuple(store.hash_ptr(p)) for p in f.input + f.output] == \
            [tuple(jstore.hash_ptr(p)) for p in g.input + g.output]
    assert tuple(store.hash_ptr(frames[-1].output[0])) == \
        tuple(jstore.hash_ptr(jframes[-1].output[0]))


# (program, expected result or None, continuation, iterations), from
# tests/test_eval.py (reference src/lem/tests/eval_tests.rs)
CASES = [
    ("((lambda (x) x) 123)", "123", ContTag.Terminal, 4),
    ("(cons 1 2)", "(1 . 2)", ContTag.Terminal, 3),
    ("((commit (lambda (x) x)) nil)", "nil", ContTag.Terminal, 6),
    ("(+ 2 (+ 3 4))", "9", ContTag.Terminal, 6),
    ("(/ 21 0)", None, ContTag.Error, 3),
    ("(let ((a 1) (b 2)) (+ a b))", "3", ContTag.Terminal, 7),
    ("(letrec ((a 1)))", None, ContTag.Error, 1),
    ("""(letrec ((exp (lambda (base exponent)
                          (if (= 0 exponent)
                              1
                              (* base (exp base (- exponent 1)))))))
                  (exp 5 3))""", "125", ContTag.Terminal, 56),
]


@pytest.mark.parametrize("src,expected,cont,iters", CASES,
                         ids=[c[0][:32] for c in CASES])
def test_eval_iterations_and_result(src, expected, cont, iters):
    store = Store(BN256_SCALAR, device="cpu")
    frames = evaluate(None, read_with_default_state(store, src), store,
                      10000)
    out = frames[-1].output
    assert len(frames) == iters
    assert out[2].tag == cont
    if expected is not None:
        want = read_with_default_state(store, expected)
        assert store.hash_ptr(out[0]) == store.hash_ptr(want)
    jstore = JaxStore(JAX_BN256, use_device=False)
    jframes = jax_evaluate(None, jax_read(jstore, src), jstore, 10000)
    assert tuple(store.hash_ptr(out[0])) == \
        tuple(jstore.hash_ptr(jframes[-1].output[0]))
