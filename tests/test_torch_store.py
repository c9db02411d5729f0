"""The port's Store and reader against the JAX package's, with host
hashing on the JAX side (``use_device=False``) and the batched plain
path on the port's (``device="cpu"``). Digests are exact."""

import numpy as np
import pytest
import torch

from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.store import core
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.symbol import user_sym
from test_torch_field import one_torch_thread  # noqa: F401

PROGRAMS = [
    "(lambda (x) x)",
    "(+ 1 2)",
    '"hello, world"',
    ":key",
    "'(1 2 . 3)",
    "123u64",
    "#\\a",
    "(letrec ((next (lambda (a b) (next b (+ a b)))) (fib (next 0 1))) (fib))",
    "(let ((make-adder (lambda (x) (lambda (y) (+ x y))))) ((make-adder 2) 3))",
]


@pytest.mark.parametrize("src", PROGRAMS, ids=[p[:24] for p in PROGRAMS])
def test_read_and_hash_match_jax(src):
    store = Store(BN256_SCALAR, device="cpu")
    jstore = JaxStore(JAX_BN256, use_device=False)
    ptr = read_with_default_state(store, src)
    jptr = jax_read(jstore, src)
    assert tuple(ptr) == tuple(jptr)
    store.hydrate_z_cache()
    jstore.hydrate_z_cache()
    assert tuple(store.hash_ptr(ptr)) == tuple(jstore.hash_ptr(jptr))


def test_commit_anchors():
    """commit(Num(0)) and (commit (lambda (x) x)), reference
    src/lem/store.rs:1473 and src/lem/tests/eval_tests.rs:379."""
    store = Store(BN256_SCALAR, device="cpu")
    assert store.fetch_f(store.commit(store.num_u64(0))) == \
        0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201
    x = store.intern_symbol(user_sym("x"))
    fun = store.intern_fun(store.list([x]), x, store.intern_empty_env())
    assert store.fetch_f(store.commit(fun)) == \
        0x2f31ee658b82c09daebbd2bd976c9d6669ad3bd6065056763797d5aaf4a3001b


def record_batches(monkeypatch) -> list:
    """(arity, size) of every wave the store hashes as one batch."""
    batches = []

    def spy(field, arity, pres, device=None):
        batches.append((arity, len(pres)))
        return K.hash_batch(field, arity, pres, device)

    monkeypatch.setattr(core, "hash_batch", spy)
    return batches


def test_hydrate_wide_wave_matches_jax_and_host(monkeypatch):
    """A wave of 96 conses (>= the threshold of 64) hashes as one batch on
    the plain path; digests equal the JAX store's and host hashing."""
    batches = record_batches(monkeypatch)
    rng = np.random.default_rng(11)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=96)]
    store = Store(BN256_SCALAR, device="cpu")
    jstore = JaxStore(JAX_BN256, use_device=False)
    ptrs = [store.cons(store.num(v), store.num(v + 1)) for v in vals]
    jptrs = [jstore.cons(jstore.num(v), jstore.num(v + 1)) for v in vals]
    store.hydrate_z_cache()
    jstore.hydrate_z_cache()
    assert batches == [(4, 96)]
    host = Store(BN256_SCALAR, device="cpu")
    hptrs = [host.cons(host.num(v), host.num(v + 1)) for v in vals]
    for p, jp, hp in zip(ptrs, jptrs, hptrs):
        z = store.hash_ptr(p)
        assert tuple(z) == tuple(jstore.hash_ptr(jp))
        assert z.digest == host.hash_ptr_val(hp.val)


def test_store_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert Store(BN256_SCALAR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Store(BN256_SCALAR)


def test_store_rejects_other_devices():
    with pytest.raises(ValueError):
        Store(BN256_SCALAR, device="meta")
