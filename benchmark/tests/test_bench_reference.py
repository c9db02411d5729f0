"""The plain reference against the port, on the CPU at a tiny size."""

from __future__ import annotations

import random

import pytest

from benchmark.reference import curve, spartan
from benchmark.reference.poseidon import poseidon_hash

BN256_R = curve.BN254_R


def test_poseidon_meets_the_rust_reference_anchor():
    # commit(Num(0)) over bn256, lurk-beta src/lem/store.rs:1473
    assert poseidon_hash(BN256_R, [0, 4, 0]) == \
        0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201


@pytest.mark.parametrize("modulus", [curve.BN254_R, curve.BN254_Q])
@pytest.mark.parametrize("arity", [3, 4, 6, 8])
def test_poseidon_equals_the_port(arity, modulus):
    from lurk_tpu_torch.fields import BN256_SCALAR, GRUMPKIN_SCALAR
    from lurk_tpu_torch.poseidon.host import hash_preimage
    field = BN256_SCALAR if modulus == curve.BN254_R else GRUMPKIN_SCALAR
    rng = random.Random(arity)
    for _ in range(3):
        pre = [rng.randrange(modulus) for _ in range(arity)]
        assert poseidon_hash(modulus, pre) == hash_preimage(field, pre)


def test_kzg_trapdoor_commits_as_the_srs():
    from lurk_tpu_torch.proof.hyperkzg import _fixed_base_mul, \
        _fixed_base_mul_table, _tau
    from lurk_tpu_torch.curves.weierstrass import BN254_G1
    t = spartan.tau()
    assert t == _tau()
    table, c = _fixed_base_mul_table(BN254_G1.generator)
    coeffs = [3, 0, 7, 11]
    expect = None
    for i, v in enumerate(coeffs):
        expect = BN254_G1.add(expect, BN254_G1.mul(
            v, _fixed_base_mul(table, c, pow(t, i, BN256_R))))
    assert spartan.kzg_commit(spartan.obj(coeffs), spartan.powers(
        t, len(coeffs), BN256_R)) == expect


@pytest.mark.parametrize("curve_name", ["bn254-g1", "grumpkin"])
def test_transcript_equals_the_ports(curve_name):
    from lurk_tpu_torch.curves.weierstrass import BN254_G1, GRUMPKIN
    from lurk_tpu_torch.proof.transcript import Transcript as Theirs
    from benchmark.reference.transcript import Transcript
    ours_c, theirs_c = {"bn254-g1": (curve.BN254, BN254_G1),
                        "grumpkin": (curve.GRUMPKIN, GRUMPKIN)}[curve_name]
    ours, theirs = Transcript(ours_c, b"test"), Theirs(theirs_c, b"test")
    rng = random.Random(curve_name)
    for _ in range(3):
        for tr in (ours, theirs):
            tr.absorb(12345)
            tr.absorb_point(None)
            tr.absorb_point(ours_c.generator)
        k = rng.randrange(ours_c.order)
        ours.absorb_scalar(k)
        theirs.absorb_scalar(k)
        assert ours.squeeze() == theirs.squeeze()


def test_grumpkin_key_and_msm_equal_the_ports():
    from lurk_tpu_torch.curves.weierstrass import GRUMPKIN
    label = b"lurk_tpu.ck.grumpkin"
    ours = curve.GRUMPKIN.derive(label, 0, 70)
    assert ours == [tuple(p) for p in
                    GRUMPKIN.derive_generators_from(label, 0, 70)]
    rng = random.Random(3)
    scalars = [rng.randrange(GRUMPKIN.order) for _ in ours]
    assert curve.GRUMPKIN.msm(scalars, ours) == \
        tuple(GRUMPKIN.pippenger(scalars, ours))


def _run(man, cell, seed=7):
    from benchmark.harness.cell import run_cell
    return run_cell(man, cell, seed, 0.0, False, "cpu")


def test_tiny_fib_cell_is_correct(tiny_manifest):
    out = _run(tiny_manifest, "fib-tiny.prove")
    assert out["failed"] == 0 and out["attempted"] == 1
    assert all(v == 0 for v in out["numbers"].values()), out["numbers"]
    assert set(out["metrics"]) == {"prove_s", "setup_s"}


def test_tiny_sha256_cell_is_correct(tiny_manifest):
    out = _run(tiny_manifest, "sha256-tiny.compressed")
    assert out["failed"] == 0
    assert all(v == 0 for v in out["numbers"].values()), out["numbers"]
    assert set(out["metrics"]) == {"compressed_proof_s", "setup_s"}
