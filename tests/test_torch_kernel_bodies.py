"""The CUDA kernels' per-thread bodies on the CPU: csrc/msm.cu (K6),
csrc/poseidon_folded.cu, csrc/poseidon.cu (K1) and csrc/poseidon_dense.cu
(K2) compile with g++ through ``csrc/host/kernel_bodies.cpp``
(``native.load_host``, cached by the sources' content), which runs them
in the order their launchers do, K1 and K2 in both shapes (a lane group
per hash and one thread per hash). Held bit for bit against the plain
versions (``msm_plain``, ``poseidon_hash_folded_plain``,
``poseidon_hash_plain``, ``poseidon_hash_dense_plain``) and the host
oracles (``Curve.pippenger``, the port's ``hash_preimage``, the JAX
package's ``hash_preimage_opt`` and ``hash_preimage``); the card's own
runs are in test_torch_cuda.py."""

import ctypes

import numpy as np
import pytest
import torch

from lurk_tpu.fields import FIELDS as JAX_FIELDS
from lurk_tpu.poseidon.host import hash_preimage as jax_hash_preimage
from lurk_tpu.poseidon.opt_spec import (
    hash_preimage_opt as jax_hash_preimage_opt,
)
from lurk_tpu_torch import native
from lurk_tpu_torch.curves.weierstrass import CURVE_FOR_FIELD
from lurk_tpu_torch.fields import FIELDS
from lurk_tpu_torch.msm import kernel as M
from lurk_tpu_torch.ops import field as F
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.poseidon.host import hash_preimage
from test_torch_field import one_torch_thread  # noqa: F401

CASES = [(name, arity) for name in sorted(FIELDS) for arity in (3, 4, 6, 8)]
CURVES = {c.name: c for c in CURVE_FOR_FIELD.values()}
BN254 = CURVES["bn254-g1"]
P = ctypes.c_void_p


@pytest.fixture(scope="module")
def lib():
    lib = native.load_host("kernel_bodies")
    ll, i = ctypes.c_longlong, ctypes.c_int
    lib.lurk_host_msm.argtypes = [P, P, ll, P, P, ctypes.c_void_p]
    lib.lurk_host_msm.restype = i
    lib.lurk_host_poseidon_folded.argtypes = [P, P, P, i, i, i, ll]
    lib.lurk_host_poseidon_folded.restype = i
    for fn in (lib.lurk_host_poseidon_sparse, lib.lurk_host_poseidon_dense):
        fn.argtypes = [P, P, P, P, i, i, i, ll]
        fn.restype = i
    lib.lurk_host_sqr.argtypes = [P, i, P, ctypes.c_uint32, P, P]
    lib.lurk_host_wide_row.argtypes = [P, P, i, P, ctypes.c_uint32, P]
    lib.lurk_host_mul_b3.argtypes = [P, P, P]
    return lib


def ptr(a: np.ndarray):
    return a.ctypes.data_as(P)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_wide_row_takes_the_largest_values(lib, name):
    """66 products of p - 1 (more than the folded kernel's longest row,
    62 terms) reduce once to the right value."""
    p = FIELDS[name].modulus
    rng = np.random.default_rng(3)
    for vals in ([p - 1] * 132,
                 [int(v) % p for v in rng.integers(0, 1 << 62, 132)]):
        words = F.ints_to_words(vals).astype("<u4")
        out = np.zeros(8, dtype="<u4")
        lib.lurk_host_wide_row(ptr(words[:66]), ptr(words[66:]), 66,
                               ptr(F.ints_to_words([p]).astype("<u4")),
                               (-pow(p, -1, 1 << 32)) % (1 << 32), ptr(out))
        want = sum(a * b for a, b in zip(vals[:66], vals[66:])) \
            * pow(2, -288, p) % p
        assert int(F.words_to_ints(out[None])[0]) == want


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sqr_matches_mul(lib, name):
    """fe::sqr (36 wide products, an eight-step reduction) gives
    fe::mul(a, a) = a^2 / 2^256 mod p on 0, 1, p - 1 and random
    elements."""
    p = FIELDS[name].modulus
    rng = np.random.default_rng(5)
    vals = [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(32), "little")
                                   % p for _ in range(12)]
    words = F.ints_to_words(vals).astype("<u4")
    sq, mu = np.zeros_like(words), np.zeros_like(words)
    lib.lurk_host_sqr(ptr(words), len(vals),
                      ptr(F.ints_to_words([p]).astype("<u4")),
                      (-pow(p, -1, 1 << 32)) % (1 << 32), ptr(sq), ptr(mu))
    want = [v * v * pow(2, -256, p) % p for v in vals]
    assert list(F.words_to_ints(sq)) == want == list(F.words_to_ints(mu))


@pytest.mark.parametrize("curve_name", ["bn254-g1", "grumpkin", "pallas",
                                        "vesta"])
def test_mul_b3_by_additions(lib, curve_name):
    """K6 multiplies by 3b (9, -51, 15, 15) with additions; on Montgomery
    elements that is the same product mod p."""
    curve = CURVES[curve_name]
    p = curve.p
    params = np.ascontiguousarray(M.curve_params(curve, "cpu").numpy()
                                  .view("<u4"))
    for a in (0, 1, p - 1, 0x1234567 << 200 | 0xABCDEF):
        out = np.zeros(8, dtype="<u4")
        lib.lurk_host_mul_b3(ptr(params), ptr(F.ints_to_words([a % p])
                                              .astype("<u4")), ptr(out))
        assert int(F.words_to_ints(out[None])[0]) == 3 * curve.b * a % p


def eight_lanes(field, arity: int, seed: int) -> np.ndarray:
    """int32[arity, 16, 8]: lane 0 all p - 1, lane 1 all 0, the rest
    random canonical limbs."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(arity, 16, 8), dtype=np.int32)
    x[:, 15, :] %= field.modulus >> 240
    x[:, :, 0] = np.array(F.int_to_limbs(field.modulus - 1))[None]
    x[:, :, 1] = 0
    return x


@pytest.mark.parametrize("name,arity", CASES)
def test_folded_body_matches_plain(lib, name, arity):
    field = FIELDS[name]
    b = 8
    x = eight_lanes(field, arity, 300 + arity)
    lay = K._folded_layout(field, arity)
    consts = K.folded_constants(field, arity, "cpu").numpy().view("<u4")
    out = np.zeros((16, b), dtype="<u4")
    assert lib.lurk_host_poseidon_folded(
        ptr(np.ascontiguousarray(x.view("<u4"))), ptr(out),
        ptr(np.ascontiguousarray(consts)), arity, lay.rf, lay.rp, b) == 0
    got = out.view(np.int32)
    assert np.array_equal(got, K.poseidon_hash_folded_plain(
        field, arity, torch.from_numpy(x)).numpy())
    digests = F.limbs_to_ints(got[:, :2].T)
    assert digests == [hash_preimage(field, [field.modulus - 1] * arity),
                       hash_preimage(field, [0] * arity)]


# kernel -> (host runner, layout, buffer, plain version, JAX oracle)
SHAPED = {
    "sparse": ("lurk_host_poseidon_sparse", K._layout, K.constants,
               K.poseidon_hash_plain, jax_hash_preimage_opt),
    "dense": ("lurk_host_poseidon_dense", K._dense_layout, K.dense_constants,
              K.poseidon_hash_dense_plain, jax_hash_preimage),
}


@pytest.mark.parametrize("kernel", sorted(SHAPED))
@pytest.mark.parametrize("name,arity", CASES)
def test_shaped_body_matches_plain_and_jax(lib, kernel, name, arity):
    """K1's and K2's bodies in both shapes (the lane group, its lanes as
    arrays, and one thread per hash) on 8 lanes: all p - 1, all 0, and
    random canonical preimages; equal to the plain version and to the
    JAX package's host hash of the same schedule, every lane."""
    runner, layout, buffer, plain, oracle = SHAPED[kernel]
    field = FIELDS[name]
    b = 8
    x = eight_lanes(field, arity, 400 + arity)
    lay = layout(field, arity)
    consts = np.ascontiguousarray(buffer(field, arity, "cpu").numpy()
                                  .view("<u4"))
    group, thread = (np.zeros((16, b), dtype="<u4") for _ in range(2))
    assert getattr(lib, runner)(
        ptr(np.ascontiguousarray(x.view("<u4"))), ptr(group), ptr(thread),
        ptr(consts), arity, lay.rf, lay.rp, b) == 0
    want = plain(field, arity, torch.from_numpy(x)).numpy()
    assert np.array_equal(group.view(np.int32), want)
    assert np.array_equal(thread.view(np.int32), want)
    pres = F.limbs_to_ints(x.transpose(2, 0, 1).reshape(-1, 16))
    assert F.limbs_to_ints(want.T) == [
        oracle(JAX_FIELDS[name], pres[arity * j:arity * (j + 1)])
        for j in range(b)]


def skewed(order: int, n: int, rng) -> list:
    """n scalars as skewed as a witness: long runs of 0, 1, order - 1 and
    three large values, and 40 distinct random ones, shuffled."""
    big = [int.from_bytes(rng.bytes(32), "little") % order for _ in range(43)]
    runs = [(0, 200), (1, 60), (order - 1, 40), (big[0], 320), (big[1], 300),
            (big[2], 64)]
    vals = [v for v, k in runs for _ in range(k)] + big[3:]
    vals += [big[0]] * (n - len(vals))
    return [vals[i] for i in rng.permutation(n)]


def run_lengths(order: int, n: int, rng) -> list:
    """Window-0 runs (digits below 2^15 touch no other window) of 16, 1,
    7, 8, 9 and 25 entries: two whole slices of the kernel's 8 entries,
    then runs of 1, s - 1, s, s + 1 and 3 s + 1 that start and end on
    and off the slice edges."""
    return [d + 1 for d, k in enumerate((16, 1, 7, 8, 9, 25))
            for _ in range(k)]


@pytest.mark.parametrize("kind", ["skewed", "run_lengths"])
def test_msm_body_matches_plain(lib, kind):
    """Scalars over bases that repeat and that meet their negations,
    slices of 8 entries: 2^10 skewed scalars, whose runs cross many
    slices and need several levels of boundary records, and 66 small
    scalars in runs around the slice length."""
    rng = np.random.default_rng(11)
    base = BN254.derive_generators_from(b"test_torch_kernel_bodies", 0, 256)
    pts = base * 3 + [BN254.neg(q) for q in base]
    scal = {"skewed": skewed, "run_lengths": run_lengths}[kind](
        BN254.order, 1 << 10, rng)
    n = len(scal)
    table = M.MsmTable.build(BN254, pts, "cpu")
    rows = np.ascontiguousarray(table.rows.numpy().view("<u4"))
    params = np.ascontiguousarray(M.curve_params(BN254, "cpu").numpy()
                                  .view("<u4"))
    out = np.zeros((3, 8), dtype="<u4")
    longest = ctypes.c_longlong()
    assert lib.lurk_host_msm(ptr(rows), ptr(M.pack_scalar_words(
        scal, BN254.order)), n, ptr(params), ptr(out),
        ctypes.byref(longest)) == 0
    got = M.to_affine(BN254, torch.from_numpy(out.view(np.int32)))
    assert longest.value >= 320 if kind == "skewed" else longest.value == 25
    assert got == BN254.pippenger(scal, pts[:n])
    # the plain version on the same function: one lane per distinct
    # scalar, its bases summed
    groups = {}
    for s, q in zip(scal, pts):
        groups[s] = BN254.add(groups.get(s), q)
    lanes = M.MsmTable.build(BN254, list(groups.values()), "cpu")
    words = torch.from_numpy(M.pack_scalar_words(
        list(groups) + [0] * (lanes.n - len(groups)), BN254.order)
        .view(np.int32))
    assert got == M.to_affine(BN254, M.msm_plain(BN254, lanes.rows, words))
