"""The CUDA kernels against their plain PyTorch versions on the card:
K1 (sparse Poseidon), K2 (dense Poseidon), K6 (MSM), the sharded prover
layer over [cuda:0, cuda:0], and the folded Poseidon (K3b/K4b's
counterpart) with the bench's Poseidon figures through each schedule.

Needs a CUDA card and nvcc; every case skips without a card. Imports
nothing of the JAX package, so it runs where jax is not installed:
``python -m pytest tests/test_torch_cuda.py -q`` on the GPU machine.
"""

import numpy as np
import pytest
import torch

from lurk_tpu_torch import bench
from lurk_tpu_torch.curves.weierstrass import CURVE_FOR_FIELD
from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS
from lurk_tpu_torch.msm import kernel as M
from lurk_tpu_torch.parallel import sharding
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.poseidon.host import hash_preimage

CASES = [(name, arity) for name in sorted(FIELDS) for arity in (3, 4, 6, 8)]
CURVE_BY_NAME = {c.name: c for c in CURVE_FOR_FIELD.values()}


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


# ---------------------------------------------------------------------------
# K2 (dense Poseidon), K6 (MSM) and the sharded prover layer
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,arity", CASES)
def test_dense_kernel_matches_plain(card, name, arity):
    field = FIELDS[name]
    rng = np.random.default_rng(100 + arity)
    limbs = rng.integers(0, 1 << 16, size=(arity, 16, 700), dtype=np.int32)
    limbs[:, 15, :] %= field.modulus >> 240
    x = torch.from_numpy(limbs).to(card)
    launches = K.dense_launches
    got = K.poseidon_hash_dense(field, arity, x)
    assert K.dense_launches == launches + 1
    assert torch.equal(got, K.poseidon_hash_dense_plain(field, arity, x))
    assert torch.equal(got, K.poseidon_hash(field, arity, x))


@pytest.mark.cuda
@pytest.mark.parametrize("curve_name", ["bn254-g1", "grumpkin", "pallas",
                                        "vesta"])
def test_msm_kernel_matches_plain(card, curve_name):
    curve = CURVE_BY_NAME[curve_name]
    n = 1 << 10
    pts = curve.derive_generators_from(b"test_torch_cuda", 0, n - 8)
    pts += pts[:4] + [curve.neg(pts[0]), curve.neg(pts[1])] + [None] * 2
    tab = M.MsmTable.build(curve, pts, card)
    rng = np.random.default_rng(7)
    scal = [0, 1, curve.order - 1, curve.order + 3] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(n - 4)]
    words = torch.from_numpy(
        M.pack_scalar_words(scal, curve.order).view(np.int32)).to(card)
    launches = M.launches
    got = M.to_affine(curve, M.msm_words(tab, words))
    assert M.launches == launches + 1
    want = M.to_affine(curve, M.msm_plain(curve, tab.rows, words))
    assert got == want and got is not None


@pytest.mark.cuda
def test_sharded_paths_on_one_card_twice(card):
    devices = [torch.device("cuda", 0)] * 2
    pres = [[i, 2 * i, 3 * i, BN256_SCALAR.modulus - 1 - i]
            for i in range(150)]
    before = K.dense_launches
    assert sharding.shard_hash_batch_ints(devices, BN256_SCALAR, 4, pres) \
        == [hash_preimage(BN256_SCALAR, p) for p in pres]
    assert K.dense_launches == before + 2
    curve = CURVE_BY_NAME["bn254-g1"]
    pts = curve.derive_generators_from(b"test_torch_cuda.shard", 0, 300)
    scal = list(range(1, 301))
    single = M.MsmTable.build(curve, pts, card).msm(scal)
    assert sharding.ShardedMsmTable(devices, curve, pts).msm(scal) == single


@pytest.mark.cuda
def test_msm_wrapper_rejects_bad_words(card):
    curve = CURVE_BY_NAME["bn254-g1"]
    tab = M.MsmTable.build(curve, [curve.generator], card)
    with pytest.raises(ValueError):
        M.msm_words(tab, torch.zeros((tab.n, 8), dtype=torch.int64,
                                     device=card))
    with pytest.raises(ValueError):
        M.msm_words(tab, torch.zeros((tab.n, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the folded Poseidon and the bench
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,arity", CASES)
def test_folded_kernel_matches_plain(card, name, arity):
    field = FIELDS[name]
    rng = np.random.default_rng(200 + arity)
    limbs = rng.integers(0, 1 << 16, size=(arity, 16, 700), dtype=np.int32)
    limbs[:, 15, :] %= field.modulus >> 240
    limbs[:, :, 0] = 0
    x = torch.from_numpy(limbs).to(card)
    launches = K.folded_launches
    got = K.poseidon_hash_folded(field, arity, x)
    assert K.folded_launches == launches + 1
    assert torch.equal(got, K.poseidon_hash_folded_plain(field, arity, x))
    assert torch.equal(got, K.poseidon_hash(field, arity, x))


@pytest.mark.cuda
def test_folded_kernel_buffer_and_input_checks(card):
    x = torch.zeros((8, 16, 130), dtype=torch.int32, device=card)
    consts = K.folded_constants(BN256_SCALAR, 8, card).clone()
    assert torch.equal(K.poseidon_hash_folded(BN256_SCALAR, 8, x, consts),
                       K.poseidon_hash_folded(BN256_SCALAR, 8, x))
    with pytest.raises(ValueError):
        K.poseidon_hash_folded(BN256_SCALAR, 8, x, consts.cpu())
    with pytest.raises(ValueError):
        K.poseidon_hash_folded(BN256_SCALAR, 8, x[..., ::2])
    pres = [[i, BN256_SCALAR.modulus - 1 - i, 3, 4] for i in range(70)]
    assert K.hash_batch_folded(BN256_SCALAR, 4, pres, device=card) == \
        [hash_preimage(BN256_SCALAR, p) for p in pres]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(bench.SCHEDULES))
def test_bench_poseidon_figures(card, schedule):
    line = bench.poseidon_bench(schedule, card)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "poseidon4_hashes_per_s" and line["value"] > 0
