"""The CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA card and nvcc; every case skips without a card. Imports
nothing of the JAX package, so it runs where jax is not installed:
``python -m pytest tests/test_torch_cuda.py -q`` on the GPU machine.
"""

import numpy as np
import pytest
import torch

from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.poseidon.host import hash_preimage

CASES = [(name, arity) for name in sorted(FIELDS) for arity in (3, 4, 6, 8)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,arity", CASES)
def test_poseidon_kernel_matches_plain(card, name, arity):
    field = FIELDS[name]
    rng = np.random.default_rng(arity)
    limbs = rng.integers(0, 1 << 16, size=(arity, 16, 700), dtype=np.int32)
    limbs[:, 15, :] %= field.modulus >> 240
    x = torch.from_numpy(limbs).to(card)
    launches = K.launches
    got = K.poseidon_hash(field, arity, x)
    assert K.launches == launches + 1
    assert torch.equal(got, K.poseidon_hash_plain(field, arity, x))


@pytest.mark.cuda
def test_hash_batch_on_card_matches_host(card):
    pres = [[i, 2 * i, 3 * i, BN256_SCALAR.modulus - 1 - i]
            for i in range(70)]
    assert K.hash_batch(BN256_SCALAR, 4, pres, device=card) == \
        [hash_preimage(BN256_SCALAR, p) for p in pres]


@pytest.mark.cuda
def test_poseidon_kernel_takes_a_constant_buffer(card):
    x = torch.zeros((4, 16, 130), dtype=torch.int32, device=card)
    consts = K.constants(BN256_SCALAR, 4, card).clone()
    assert torch.equal(K.poseidon_hash(BN256_SCALAR, 4, x, consts),
                       K.poseidon_hash(BN256_SCALAR, 4, x))
    with pytest.raises(ValueError):
        K.poseidon_hash(BN256_SCALAR, 4, x, consts.cpu())


@pytest.mark.cuda
def test_poseidon_kernel_rejects_strided_input(card):
    x = torch.zeros((4, 16, 8), dtype=torch.int32, device=card)[..., ::2]
    with pytest.raises(ValueError):
        K.poseidon_hash(BN256_SCALAR, 4, x)
