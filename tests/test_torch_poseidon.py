"""The port's batched Poseidon (lurk_tpu_torch.poseidon.kernel) against
the JAX package's plain Poseidon paths, bit for bit (tolerance 0).

On the CPU ``poseidon_hash`` runs the plain version of the CUDA kernel
(the sparse schedule on ops.field). The JAX side is the dense host
oracle ``hash_preimage`` and the sparse host schedule
``hash_preimage_opt``; the Pallas builders (the folded K3b/K4b among
them) are pinned against these two by the JAX package's own tests, so
interpret-mode Pallas is not run here. The folded schedule's tables are
held against the JAX package's ``partial_schedule``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lurk_tpu.fields import FIELDS as JAX_FIELDS
from lurk_tpu.poseidon.host import hash_preimage as jax_hash_preimage
from lurk_tpu.poseidon.opt_spec import (
    hash_preimage_opt as jax_hash_preimage_opt,
    opt_poseidon_spec as jax_opt_poseidon_spec,
)
from lurk_tpu.poseidon.partial_opt import (
    partial_schedule as jax_partial_schedule,
    run_partial_span_host as jax_run_partial_span_host,
)
from lurk_tpu.poseidon.spec import poseidon_spec as jax_poseidon_spec
from lurk_tpu_torch import bench
from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS
from lurk_tpu_torch.ops import field as F
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.poseidon.partial_opt import (
    partial_schedule, run_partial_span_host,
)
from test_torch_field import one_torch_thread  # noqa: F401

CASES = [(name, arity) for name in sorted(FIELDS) for arity in (3, 4, 6, 8)]
TRIE_ROOTS = [
    0x1ca5b207085f3f0f324a2e0704b18fff1cda2e2d686aa85343fea91df77bf35b,
    0x0637ddaef5cd53ba6711c328952208d846222066701e10c34d3a6df7350de8aa,
    0x08127a45502f5939273edd1957c8748ae39992e2a459d99f999992a842df99a5,
    0x12c2ef2ab5df25442fe23d8711bf985f02c39e83930517f7103d4bd4228c6cfb,
]


def preimages(p: int, arity: int, seed: int):
    """A few random preimages plus all-zero and all-(p-1)."""
    rng = np.random.default_rng(seed)
    rand = [[int.from_bytes(rng.bytes(32), "little") % p
             for _ in range(arity)] for _ in range(3)]
    return rand + [[0] * arity, [p - 1] * arity]


@pytest.mark.parametrize("name,arity", CASES)
def test_plain_matches_jax_host_paths(name, arity):
    field = FIELDS[name]
    pres = preimages(field.modulus, arity, seed=arity)
    x = K.preimages_to_tensor(field, arity, pres, "cpu")
    out = K.poseidon_hash(field, arity, x)
    assert out.dtype == torch.int32 and tuple(out.shape) == (16, len(pres))
    got = F.limbs_to_ints(out.numpy().T)
    jf = JAX_FIELDS[name]
    assert got == [jax_hash_preimage(jf, pre) for pre in pres]
    assert got == [jax_hash_preimage_opt(jf, pre) for pre in pres]


def _limbs(values) -> np.ndarray:
    """Nested lists of field elements -> uint32[..., 16] limbs."""
    arr = np.asarray(values, dtype=object)
    flat = F.ints_to_limbs([int(v) for v in arr.reshape(-1)])
    return flat.astype(np.uint32).reshape(*arr.shape, 16)


def jax_constant_arrays(name: str, arity: int) -> dict:
    """The JAX package's Poseidon constants as numpy limbs."""
    jf = JAX_FIELDS[name]
    spec = jax_poseidon_spec(jf, arity)
    o = jax_opt_poseidon_spec(jf, arity)
    return {
        "domain_tag": _limbs(spec.domain_tag),
        "mds": _limbs(spec.mds),
        "pre_keys": _limbs(o.pre_keys),
        "post_keys": _limbs(o.post_keys),
        "pre_sparse": _limbs(o.pre_sparse),
        "sparse_m00": _limbs([s.m00 for s in o.sparse]),
        "sparse_w": _limbs([s.w for s in o.sparse]),
        "sparse_v_hat": _limbs([s.v_hat for s in o.sparse]),
    }


@pytest.mark.parametrize("name,arity", CASES)
def test_constants_from_jax_numpy(name, arity):
    """The JAX package's constants, handed over as numpy limbs, give the
    port's own constant buffer bit for bit."""
    got = K.constants_from_numpy(FIELDS[name],
                                 jax_constant_arrays(name, arity), "cpu")
    want = K.constants(FIELDS[name], arity, "cpu")
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_carried_constants_drive_the_hash():
    """A buffer built from the JAX package's constants, passed as
    ``consts``, gives the JAX digests; a buffer of the wrong size is
    refused."""
    consts = K.constants_from_numpy(
        BN256_SCALAR, jax_constant_arrays("bn256", 4), "cpu")
    pres = preimages(BN256_SCALAR.modulus, 4, seed=9)
    x = K.preimages_to_tensor(BN256_SCALAR, 4, pres, "cpu")
    got = F.limbs_to_ints(K.poseidon_hash(BN256_SCALAR, 4, x, consts)
                          .numpy().T)
    assert got == [jax_hash_preimage(JAX_FIELDS["bn256"], pre)
                   for pre in pres]
    with pytest.raises(ValueError):
        K.poseidon_hash(BN256_SCALAR, 4, x, consts[:-8])


def test_commit_num0_and_trie_root_anchors():
    """Reference anchors through the batched path: commit(Num(0)) =
    hash3([0, Num, 0]) and the chained hash8 empty trie roots."""
    assert K.hash_batch(BN256_SCALAR, 3, [[0, 4, 0]], device="cpu") == [
        0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201]
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch(BN256_SCALAR, 8, [[h] * 8], device="cpu")
        assert h == want


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 16, 3), dtype=torch.int64),      # dtype
    torch.zeros((3, 16, 3), dtype=torch.int32),      # arity
    torch.zeros((4, 8, 3), dtype=torch.int32),       # limbs
    torch.zeros((4, 16), dtype=torch.int32),         # rank
])
def test_poseidon_hash_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        K.poseidon_hash(BN256_SCALAR, 4, bad)


def test_hash_batch_checks_preimage_length():
    with pytest.raises(ValueError):
        K.hash_batch(BN256_SCALAR, 4, [[1, 2, 3]], device="cpu")
    assert K.hash_batch(BN256_SCALAR, 4, [], device="cpu") == []


def test_hash_batch_padded_is_hash_batch():
    pres = [[1, 2, 3, 4], [5, 6, 7, 8]]
    assert K.hash_batch_padded(BN256_SCALAR, 4, pres, device="cpu") == \
        [jax_hash_preimage(JAX_FIELDS["bn256"], p) for p in pres]


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        K.hash_batch(BN256_SCALAR, 4, [[1, 2, 3, 4]])
    with pytest.raises(RuntimeError):
        K.constants(BN256_SCALAR, 4)


# ---------------------------------------------------------------------------
# the dense schedule (kernel K2's plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,arity", CASES)
def test_dense_plain_matches_jax_and_the_sparse_path(name, arity):
    field = FIELDS[name]
    pres = preimages(field.modulus, arity, seed=arity)
    x = K.preimages_to_tensor(field, arity, pres, "cpu")
    out = K.poseidon_hash_dense(field, arity, x)
    assert out.dtype == torch.int32 and tuple(out.shape) == (16, len(pres))
    got = F.limbs_to_ints(out.numpy().T)
    jf = JAX_FIELDS[name]
    assert got == [jax_hash_preimage(jf, pre) for pre in pres]
    assert got == [jax_hash_preimage_opt(jf, pre) for pre in pres]


def jax_dense_arrays(name: str, arity: int) -> dict:
    """The JAX package's Poseidon spec as numpy limbs."""
    spec = jax_poseidon_spec(JAX_FIELDS[name], arity)
    return {"domain_tag": _limbs(spec.domain_tag),
            "round_constants": _limbs(spec.round_constants),
            "mds": _limbs(spec.mds)}


@pytest.mark.parametrize("name,arity", CASES)
def test_dense_constants_from_jax_numpy(name, arity):
    got = K.dense_constants_from_numpy(FIELDS[name],
                                       jax_dense_arrays(name, arity), "cpu")
    assert got.dtype == torch.int32
    assert torch.equal(got, K.dense_constants(FIELDS[name], arity, "cpu"))


def test_carried_dense_constants_drive_the_hash():
    consts = K.dense_constants_from_numpy(
        BN256_SCALAR, jax_dense_arrays("bn256", 8), "cpu")
    pres = preimages(BN256_SCALAR.modulus, 8, seed=19)
    x = K.preimages_to_tensor(BN256_SCALAR, 8, pres, "cpu")
    got = F.limbs_to_ints(K.poseidon_hash_dense(BN256_SCALAR, 8, x, consts)
                          .numpy().T)
    assert got == [jax_hash_preimage(JAX_FIELDS["bn256"], pre)
                   for pre in pres]
    with pytest.raises(ValueError):
        K.poseidon_hash_dense(BN256_SCALAR, 8, x, consts[:-8])
    with pytest.raises(ValueError):
        K.poseidon_hash_dense(BN256_SCALAR, 4, x, consts)


def test_dense_anchors():
    assert K.hash_batch_dense(BN256_SCALAR, 3, [[0, 4, 0]], device="cpu") \
        == [0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201]
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch_dense(BN256_SCALAR, 8, [[h] * 8], device="cpu")
        assert h == want


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 16, 3), dtype=torch.int64),      # dtype
    torch.zeros((3, 16, 3), dtype=torch.int32),      # arity
    torch.zeros((4, 16), dtype=torch.int32),         # rank
])
def test_poseidon_hash_dense_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        K.poseidon_hash_dense(BN256_SCALAR, 4, bad)


def test_dense_constants_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        K.dense_constants(BN256_SCALAR, 4)
    with pytest.raises(RuntimeError):
        K.hash_batch_dense(BN256_SCALAR, 4, [[1, 2, 3, 4]])


# ---------------------------------------------------------------------------
# the folded schedule (csrc/poseidon_folded.cu's plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,arity", [(n, a) for n in ("bn256", "pallas")
                                        for a in (3, 4, 6, 8)])
def test_partial_schedule_matches_jax(name, arity):
    """The folded tables, and the host span oracle over them on a random
    state, equal the JAX package's."""
    got = partial_schedule(FIELDS[name], arity)
    want = jax_partial_schedule(JAX_FIELDS[name], arity)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    (state,) = preimages(FIELDS[name].modulus, arity + 1, seed=90 + arity)[:1]
    assert run_partial_span_host(FIELDS[name], arity, state) == \
        jax_run_partial_span_host(JAX_FIELDS[name], arity, state)


@pytest.mark.parametrize("name,arity", CASES)
def test_folded_plain_matches_jax(name, arity):
    """Random preimages, all zeros and all p-1 (test_pallas_nib.py's
    edge case) through the folded schedule give the JAX host digests."""
    field = FIELDS[name]
    pres = preimages(field.modulus, arity, seed=50 + arity)
    x = K.preimages_to_tensor(field, arity, pres, "cpu")
    out = K.poseidon_hash_folded(field, arity, x)
    assert out.dtype == torch.int32 and tuple(out.shape) == (16, len(pres))
    assert F.limbs_to_ints(out.numpy().T) == \
        [jax_hash_preimage(JAX_FIELDS[name], pre) for pre in pres]


def jax_folded_arrays(name: str, arity: int) -> dict:
    """The JAX package's spec and partial_schedule tables as numpy limbs."""
    jf = JAX_FIELDS[name]
    spec = jax_poseidon_spec(jf, arity)
    sc = jax_partial_schedule(jf, arity)
    return {"domain_tag": _limbs(spec.domain_tag),
            "round_constants": _limbs(spec.round_constants),
            "mds": _limbs(spec.mds), "alpha": _limbs(sc.alpha),
            "beta": _limbs(sc.beta), "gamma": _limbs(sc.gamma),
            "a_mat": _limbs(sc.a_mat), "b_vec": _limbs(sc.b_vec),
            "w_mat": _limbs(sc.w_mat)}


@pytest.mark.parametrize("name,arity", [("bn256", 4), ("pallas", 8)])
def test_folded_constants_from_jax_numpy(name, arity):
    """The JAX package's tables, handed over as numpy limbs, give the
    port's own folded buffer bit for bit and drive the plain version to
    the JAX digests; a buffer of the wrong size is refused."""
    field = FIELDS[name]
    consts = K.folded_constants_from_numpy(
        field, jax_folded_arrays(name, arity), "cpu")
    assert torch.equal(consts, K.folded_constants(field, arity, "cpu"))
    pres = preimages(field.modulus, arity, seed=70 + arity)
    x = K.preimages_to_tensor(field, arity, pres, "cpu")
    got = F.limbs_to_ints(K.poseidon_hash_folded(field, arity, x, consts)
                          .numpy().T)
    assert got == [jax_hash_preimage(JAX_FIELDS[name], pre) for pre in pres]
    with pytest.raises(ValueError):
        K.poseidon_hash_folded(field, arity, x, consts[:-8])
    with pytest.raises(ValueError):
        K.poseidon_hash_folded(field, 6 if arity != 6 else 4, x, consts)


def test_folded_anchors():
    assert K.hash_batch_folded(BN256_SCALAR, 3, [[0, 4, 0]], device="cpu") \
        == [0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201]
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch_folded(BN256_SCALAR, 8, [[h] * 8], device="cpu")
        assert h == want


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 16, 3), dtype=torch.int64),      # dtype
    torch.zeros((3, 16, 3), dtype=torch.int32),      # arity
    torch.zeros((4, 16), dtype=torch.int32),         # rank
])
def test_poseidon_hash_folded_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        K.poseidon_hash_folded(BN256_SCALAR, 4, bad)


def test_folded_path_and_bench_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        K.folded_constants(BN256_SCALAR, 4)
    with pytest.raises(RuntimeError):
        K.hash_batch_folded(BN256_SCALAR, 4, [[1, 2, 3, 4]])
    with pytest.raises(RuntimeError):
        bench.main([])
    with pytest.raises(SystemExit):
        bench.main(["--schedule", "ladder"])
