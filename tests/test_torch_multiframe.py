"""The port's folding-step instances (``lurk_tpu_torch.proof.multiframe``)
against the JAX package's, byte for byte: at rc = 5, the public IO ``x``
and the witness ``w`` of full synthesis and of witness-only synthesis
(host C++ Poseidon trace) equal the JAX package's witness-only instance,
which its own tests pin to its full synthesis. Integers only: tolerance
0. The JAX side runs on its host paths (``use_device=False``) with its
Python Poseidon trace (``lurk_tpu.native.poseidon.available`` patched to
False), so the C++ trace of the port is held against the Python one and
the JAX package's own C++ is not compiled here.
"""

import pytest

import lurk_tpu.native.poseidon as jax_native_poseidon
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem import eval_step as jax_eval_step
from lurk_tpu.lem import evaluate as jax_evaluate
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.proof.multiframe import MultiFrame as JaxMultiFrame
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem import eval_step, evaluate
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof.multiframe import (
    MultiFrame, chunk_frames, io_chain_checker,
)
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

RC = 5
# tests/test_witness_only.py's first two programs; the factorial's 66
# frames make 14 steps, of which the first 3 are compared
PROGRAMS = [("(+ 1 (* 2 3))", 2),
            ("(letrec ((f (lambda (n) (if (= n 0) 1 (* n (f (- n 1)))))))"
             " (f 4))", 3)]


@pytest.mark.parametrize("src,n_steps", PROGRAMS)
def test_step_instances_match_jax(monkeypatch, src, n_steps):
    monkeypatch.setattr(jax_native_poseidon, "available", lambda: False)
    store = Store(BN256_SCALAR, device="cpu")
    frames = evaluate(None, read_with_default_state(store, src), store, 1000)
    store.hydrate_z_cache()
    jstore = JaxStore(JAX_BN256, use_device=False)
    jframes = jax_evaluate(None, jax_read(jstore, src), jstore, 1000)
    jstore.hydrate_z_cache()
    step, jstep = eval_step(), jax_eval_step()
    steps = MultiFrame.from_frames(frames, RC, step, store)
    jsteps = JaxMultiFrame.from_frames(jframes, RC, jstep, jstore)
    assert len(steps) == len(jsteps) >= n_steps
    assert [(s.z_in, s.z_out) for s in steps] == \
        [(s.z_in, s.z_out) for s in jsteps]
    for mf, jmf in zip(steps[:n_steps], jsteps):
        x_j, w_j, _ = jmf.instance(jstep, jstore, witness_only=True)
        x, w, _ = mf.instance(step, store)
        assert (x, w) == (x_j, w_j)
        x, w, cs = mf.instance(step, store, witness_only=True)
        assert (x, w) == (x_j, w_j) and cs.num_constraints == 0


def test_io_chain_checker_and_chunks():
    xs = [[1] * 6 + [2] * 6, [2] * 6 + [3] * 6]
    assert io_chain_checker([1] * 6, [3] * 6)(xs)
    assert not io_chain_checker([1] * 6, [4] * 6)(xs)
    assert not io_chain_checker([1] * 6, [3] * 6)(xs[::-1])
    assert not io_chain_checker([1] * 6, [3] * 6)([])
    assert chunk_frames(list(range(6)), 3) == [[0, 1, 2], [3, 4, 5]]
