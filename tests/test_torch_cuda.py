"""The CUDA kernels against their plain PyTorch versions on the card:
K1 (sparse Poseidon) and K2 (dense Poseidon) in both shapes (a lane
group per hash below their kThreadFrom batch, one thread per hash from
it), K6 (MSM, also reached by a packed vector's commit), the sharded
prover layer over [cuda:0, cuda:0], and the folded Poseidon (K3b/K4b's
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
from lurk_tpu_torch.hostlib.r1cs import PackedVec
from lurk_tpu_torch.msm import kernel as M
from lurk_tpu_torch.ops import field as F
from lurk_tpu_torch.parallel import sharding
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.poseidon.host import hash_preimage
from lurk_tpu_torch.proof.nova import CommitmentKey
from test_torch_field import one_torch_thread  # noqa: F401

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
# K1 and K2 in both shapes, reached through the wrappers by the batch
# ---------------------------------------------------------------------------


SHAPED = {"sparse": ("poseidon", K.poseidon_hash, K.poseidon_hash_plain,
                     "launches"),
          "dense": ("poseidon_dense", K.poseidon_hash_dense,
                    K.poseidon_hash_dense_plain, "dense_launches")}
# batches: the main path's waves and shards, and each side of kThreadFrom
SIZES = ["1", "64", "114", "256", "344", "below", "from"]


def _batch(name: str, size: str) -> int:
    n = K.thread_from(name)
    return {"below": n - 1, "from": n}.get(size) or int(size)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arity", [4, 8])
@pytest.mark.parametrize("kernel", sorted(SHAPED))
def test_shapes_match_plain(card, kernel, arity, size):
    name, hash_fn, plain_fn, counter = SHAPED[kernel]
    b = _batch(name, size)
    field = BN256_SCALAR
    rng = np.random.default_rng(b + arity)
    limbs = rng.integers(0, 1 << 16, size=(arity, 16, b), dtype=np.int32)
    limbs[:, 15, :] %= field.modulus >> 240
    x = torch.from_numpy(limbs).to(card)
    before = getattr(K, counter)
    got = hash_fn(field, arity, x)
    assert getattr(K, counter) == before + 1
    assert torch.equal(got, plain_fn(field, arity, x))
    lanes = sorted({0, b - 1})
    pres = [F.limbs_to_ints(limbs[:, :, j]) for j in lanes]
    assert F.limbs_to_ints(got[:, lanes].cpu().numpy().T) == \
        [hash_preimage(field, pre) for pre in pres]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(SHAPED))
@pytest.mark.parametrize("name,arity", CASES)
def test_shapes_on_p_minus_1(card, kernel, name, arity):
    """Every input p - 1, in both shapes."""
    kname, hash_fn, plain_fn, _ = SHAPED[kernel]
    field = FIELDS[name]
    want = hash_preimage(field, [field.modulus - 1] * arity)
    for b in (37, K.thread_from(kname)):
        limbs = np.repeat(np.array(F.int_to_limbs(field.modulus - 1),
                                   dtype=np.int32)[None, :, None], arity,
                          axis=0)
        x = torch.from_numpy(np.repeat(limbs, b, axis=2)).to(card)
        got = hash_fn(field, arity, x)
        assert torch.equal(got, plain_fn(field, arity, x))
        assert set(F.limbs_to_ints(got.cpu().numpy().T)) == {want}


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


# ---------------------------------------------------------------------------
# the redesigned K6 (equal-length slices, boundary records) and the
# folded kernel's wide rows, on the inputs that reach their edge cases
# ---------------------------------------------------------------------------


CURVES = ["bn254-g1", "grumpkin", "pallas", "vesta"]


def _msm_case(card, curve, pts, scal):
    """Kernel = plain = host."""
    tab = M.MsmTable.build(curve, pts, card)
    words = torch.zeros((tab.n, 8), dtype=torch.int32, device=card)
    words[:len(scal)] = torch.from_numpy(
        M.pack_scalar_words(scal, curve.order).view(np.int32)).to(card)
    got = M.to_affine(curve, M._msm_cuda(tab, words))
    assert got == M.to_affine(curve, M.msm_plain(curve, tab.rows, words))
    assert got == curve.pippenger(list(scal), pts[:len(scal)])


@pytest.mark.cuda
@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_kernel_all_equal_scalars(card, curve_name):
    curve = CURVE_BY_NAME[curve_name]
    pts = curve.derive_generators_from(b"test_torch_cuda.equal", 0, 1 << 12)
    s = int.from_bytes(np.random.default_rng(5).bytes(32), "little")
    _msm_case(card, curve, pts, [s % curve.order] * len(pts))


@pytest.mark.cuda
@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_kernel_run_lengths_around_the_slice(card, curve_name):
    """Window-0 runs of 1, s - 1, s, s + 1 and 3 s + 1 entries after two
    whole slices (digits below 2^15 touch no other window; most buckets
    stay empty, runs of 0), at the kernel's slice of s = 8 entries (every
    stream of up to 2^20 entries); then with random scalars after them."""
    curve = CURVE_BY_NAME[curve_name]
    s = 8
    scal = [1] * (2 * s) + [d + 2 for d, k in enumerate(
        (1, s - 1, s, s + 1, 3 * s + 1)) for _ in range(k)]
    rng = np.random.default_rng(9)
    pts = curve.derive_generators_from(b"test_torch_cuda.runs", 0,
                                       len(scal) + (1 << 10))
    _msm_case(card, curve, pts, scal)
    scal += [int.from_bytes(rng.bytes(32), "little") % curve.order
             for _ in range(1 << 10)]
    _msm_case(card, curve, pts, scal)


@pytest.mark.cuda
@pytest.mark.parametrize("curve_name", CURVES)
def test_msm_kernel_repeated_and_negated_bases(card, curve_name):
    """Bases repeated with equal scalars (a bucket doubles its point) and
    P beside -P with equal scalars (they cancel in one bucket); then the
    same in a stream of 4 entries, which one slice holds whole."""
    curve = CURVE_BY_NAME[curve_name]
    base = curve.derive_generators_from(b"test_torch_cuda.rep", 0, 256)
    pts = base * 3 + [curve.neg(q) for q in base]
    rng = np.random.default_rng(13)
    vals = [int.from_bytes(rng.bytes(32), "little") % curve.order
            for _ in range(256)]
    _msm_case(card, curve, pts, vals * 4)
    _msm_case(card, curve, [base[0], base[0], curve.neg(base[0]), base[1]],
              [5, 5, 5, 7])


@pytest.mark.cuda
def test_msm_table_sends_only_the_scalars_rows(card):
    curve = CURVE_BY_NAME["bn254-g1"]
    pts = curve.derive_generators_from(b"test_torch_cuda.prefix", 0, 1000)
    tab = M.MsmTable.build(curve, pts, card)
    scal = list(range(3, 703))
    words = torch.zeros((tab.n, 8), dtype=torch.int32, device=card)
    words[:len(scal)] = torch.from_numpy(
        M.pack_scalar_words(scal, curve.order).view(np.int32)).to(card)
    assert tab.msm(scal) == M.to_affine(curve, M.msm_words(tab, words)) \
        == curve.pippenger(scal, pts[:len(scal)])
    assert tab.msm([]) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name,arity", CASES)
def test_folded_kernel_on_p_minus_1(card, name, arity):
    field = FIELDS[name]
    limbs = np.repeat(np.array(F.int_to_limbs(field.modulus - 1), dtype=np.int32)
                      [None, :, None], arity, axis=0)
    x = torch.from_numpy(np.repeat(limbs, 300, axis=2)).to(card)
    got = K.poseidon_hash_folded(field, arity, x)
    assert torch.equal(got, K.poseidon_hash_folded_plain(field, arity, x))
    assert torch.equal(got, K.poseidon_hash(field, arity, x))


@pytest.mark.cuda
def test_packed_commit_on_card(card):
    """CommitmentKey.commit of a PackedVec on a CUDA key: its limbs go to
    the kernel as words (one launch), equal to the commit of the ints
    and to the plain version on the same words."""
    curve = CURVE_BY_NAME["bn254-g1"]
    n = 3000
    pts = curve.derive_generators_from(b"test_torch_cuda.packed", 0, n)
    key = CommitmentKey(curve, pts, card)
    rng = np.random.default_rng(11)
    scal = [int.from_bytes(rng.bytes(32), "little") % curve.order
            for _ in range(n)]
    scal[:3] = [0, 1, curve.order - 1]
    packed = PackedVec.pack(scal, curve.order)
    launches = M.launches
    got = key.commit(packed)
    assert M.launches == launches + 1
    assert got == key.commit(scal) and got is not None
    tab = key.table().prefix(n)
    words = torch.from_numpy(packed.arr.view(np.int32).reshape(n, 8)).to(card)
    assert got == M.to_affine(curve, M.msm_plain(curve, tab.rows, words))


@pytest.mark.cuda
def test_memoset_proof_equal_on_both_devices(card):
    """The memoset NIVC prover with its key on the card (every W, T and E
    commit through K6) gives the proof the CPU key gives, and both
    verify."""
    from lurk_tpu_torch.coroutine import prove
    from lurk_tpu_torch.coroutine.circuit import DemoCircuitQuery
    from lurk_tpu_torch.coroutine.memoset import DemoQuery, Scope
    from lurk_tpu_torch.store.core import Store

    out = {}
    for dev in (card, torch.device("cpu")):
        store = Store(BN256_SCALAR, device=dev)
        scope = Scope(store, DemoQuery, default_rc=3)
        scope.query(DemoQuery(store.num(5)).to_ptr(store))
        launches = M.launches
        pp, proof = prove.MemosetProver(
            3, DemoCircuitQuery(), device=dev).prove_from_scope(scope)
        assert prove.verify(pp, proof)
        if dev.type == "cuda":
            assert M.launches == launches + 2 * 2 + 2
        out[dev.type] = ([(i, inst.comm_w, inst.x, t)
                          for i, inst, t in proof.steps],
                         {i: (list(w.w), list(w.e))
                          for i, w in proof.final_witnesses.items()},
                         proof.z0, proof.zi)
    assert out["cuda"] == out["cpu"]
