"""The port's step circuit (``lurk_tpu_torch.lem.circuit`` on
``r1cs``/``poseidon.circuit``) against the JAX package's, exactly: the
blank circuit's size, shape digest and matrices, real frames'
satisfaction, shape and witness, and the host C++ Poseidon witness trace
against the JAX package's plain Python trace. Integers only: tolerance 0.

The JAX side runs on its host paths (``Store(..., use_device=False)``):
no Pallas and no XLA compile.
"""

import numpy as np
import pytest

from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem import eval_step as jax_eval_step
from lurk_tpu.lem import evaluate as jax_evaluate
from lurk_tpu.lem.circuit import synthesize_frame as jax_synthesize_frame
from lurk_tpu.lem.interpreter import Frame as JaxFrame
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.poseidon.circuit import (
    witness_trace_and_digest as jax_witness_trace,
)
from lurk_tpu.poseidon.host import hash_preimage as jax_hash_preimage
from lurk_tpu.r1cs.cs import ConstraintSystem as JaxCS
from lurk_tpu.r1cs.cs import Shape as JaxShape
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.hostlib import poseidon as hpos
from lurk_tpu_torch.lem import eval_step, evaluate
from lurk_tpu_torch.lem.circuit import synthesize_frame
from lurk_tpu_torch.lem.interpreter import Frame
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.poseidon.circuit import (
    poseidon_witness, witness_trace_and_digest,
)
from lurk_tpu_torch.r1cs.cs import ConstraintSystem, Shape
from lurk_tpu_torch.r1cs.gadgets import alloc_num
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

# two of tests/test_circuit.py's expressions: arithmetic, and a closure
EXPRS = ["(+ 1 2)", "((lambda (x) (* x x)) 5)"]


@pytest.fixture(scope="module")
def stores():
    return Store(BN256_SCALAR, device="cpu"), \
        JaxStore(JAX_BN256, use_device=False)


@pytest.fixture(scope="module")
def blanks(stores):
    store, jstore = stores
    cs = ConstraintSystem(BN256_SCALAR)
    synthesize_frame(cs, eval_step(), store,
                     Frame.blank_frame(eval_step(), 0, store))
    jcs = JaxCS(JAX_BN256)
    jax_synthesize_frame(jcs, jax_eval_step(), jstore,
                         JaxFrame.blank_frame(jax_eval_step(), 0, jstore))
    return cs, jcs


def test_blank_step_circuit_matches_jax(blanks):
    cs, jcs = blanks
    assert (cs.num_constraints, cs.num_aux) == (11057, 9029)
    assert (jcs.num_constraints, jcs.num_aux) == (11057, 9029)
    assert cs.num_inputs == jcs.num_inputs
    assert cs.shape_digest() == jcs.shape_digest()
    assert Shape(cs).matrices_coo() == JaxShape(jcs).matrices_coo()


@pytest.mark.parametrize("expr", EXPRS)
def test_first_frames_satisfied_and_match_jax(stores, blanks, expr):
    """Frames 0 and 1 synthesize satisfied with the blank's shape; frame
    0 has the JAX package's shape digest and witness."""
    store, jstore = stores
    frames = evaluate(None, read_with_default_state(store, expr), store, 200)
    jframes = jax_evaluate(None, jax_read(jstore, expr), jstore, 200)
    assert len(frames) == len(jframes) >= 2
    for frame in frames[:2]:
        cs = ConstraintSystem(BN256_SCALAR, check=True)
        synthesize_frame(cs, eval_step(), store, frame)
        assert cs.is_satisfied() and cs.first_unsatisfied() is None
        assert cs.shape_digest() == blanks[0].shape_digest()
    cs = ConstraintSystem(BN256_SCALAR)
    synthesize_frame(cs, eval_step(), store, frames[0])
    jcs = JaxCS(JAX_BN256)
    jax_synthesize_frame(jcs, jax_eval_step(), jstore, jframes[0])
    assert cs.shape_digest() == jcs.shape_digest()
    assert cs.witness_vector() == jcs.witness_vector()


@pytest.mark.parametrize("arity", [3, 4, 6, 8])
def test_host_trace_matches_jax_python(arity):
    """The host C++ trace and digest, and the port's plain Python trace,
    equal the JAX package's Python trace; the host C++ batch digests equal
    the JAX host hash."""
    p = BN256_SCALAR.modulus
    rng = np.random.default_rng(arity)
    pres = [[int.from_bytes(rng.bytes(32), "little") % p
             for _ in range(arity)] for _ in range(2)] + [[p - 1] * arity]
    for pre in pres:
        want = jax_witness_trace(JAX_BN256, pre)
        assert hpos.witness_trace_and_digest(BN256_SCALAR, pre) == want
        assert witness_trace_and_digest(BN256_SCALAR, pre) == want
    assert hpos.hash_batch(BN256_SCALAR, arity, pres) == \
        [jax_hash_preimage(JAX_BN256, pre) for pre in pres]


def test_poseidon_witness_needs_a_witness_only_system():
    cs = ConstraintSystem(BN256_SCALAR)
    with pytest.raises(ValueError):
        poseidon_witness(cs, BN256_SCALAR, [alloc_num(cs, v)
                                            for v in (1, 2, 3, 4)])
    wcs = ConstraintSystem(BN256_SCALAR, witness_only=True)
    digest = poseidon_witness(wcs, BN256_SCALAR,
                              [alloc_num(wcs, v) for v in (1, 2, 3, 4)])
    assert digest.value == jax_hash_preimage(JAX_BN256, [1, 2, 3, 4])
    assert wcs.num_aux == 4 + 3 * (5 * 8 + 56)
