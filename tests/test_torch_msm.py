"""The port's MSM layer (lurk_tpu_torch.msm.kernel, proof.nova's
CommitmentKey) against the JAX package's, exact (points are integers).

On the CPU a table's MSM runs the kernel's plain version, and a CPU
key commits through the port's host C++ Pippenger. The JAX side
is its host Pippenger on the Python path (``native.msm`` reported
unavailable, which also keeps its C++ build out of the test), and its
``signed_digits``; the JAX device MSM is not run here (its XLA:CPU
compile takes minutes).
"""

import numpy as np
import pytest
import torch

from lurk_tpu.curves import weierstrass as JW
from lurk_tpu.msm.device_v2 import signed_digits as jax_signed_digits
from lurk_tpu.native import msm as jax_native_msm
from lurk_tpu.parallel import sharding as jax_sharding
from lurk_tpu.proof import params_cache as jax_params_cache
from lurk_tpu.proof.nova import CommitmentKey as JaxCommitmentKey
from lurk_tpu_torch.curves import weierstrass as W
from lurk_tpu_torch.msm import kernel as M
from lurk_tpu_torch.proof import nova, params_cache
from test_torch_field import one_torch_thread  # noqa: F401

CURVES = {"bn254-g1": (W.BN254_G1, JW.BN254_G1),
          "grumpkin": (W.GRUMPKIN, JW.GRUMPKIN),
          "pallas": (W.PALLAS, JW.PALLAS)}


@pytest.fixture(autouse=True)
def jax_host_pippenger(monkeypatch):
    monkeypatch.setattr(jax_native_msm, "available", lambda: False)
    monkeypatch.setattr(jax_sharding, "_PROVER_MESH", None)   # no mesh


def scalars_and_points(curve, n: int, seed: int):
    """n bases and scalars with 0, 1, order-1 and a scalar >= order, a
    repeated base and a P/-P pair with equal scalars (n >= 7); at n = 1
    one scalar >= order."""
    rng = np.random.default_rng(seed)
    pts = curve.derive_generators_from(b"test_torch_msm", 0, n)
    if n == 1:
        return [curve.order + 3], pts
    scal = [int.from_bytes(rng.bytes(32), "little") % curve.order
            for _ in range(n)]
    scal[:4] = [0, 1, curve.order - 1, curve.order + 5]
    pts[4] = pts[3]                          # repeated base
    pts[6] = curve.neg(pts[5])               # P and -P ...
    scal[6] = scal[5]                        # ... cancel
    return scal, pts


@pytest.mark.parametrize("order_name", ["pallas", "bn254-g1"])
@pytest.mark.parametrize("c_bits", [8, 12, 16])
def test_signed_digits_match_jax(order_name, c_bits):
    order = CURVES[order_name][0].order
    rng = np.random.default_rng(c_bits)
    scal = [0, 1, order - 1, order, order + 9, (1 << 256) - 1,
            1 << 254] + [int.from_bytes(rng.bytes(32), "little")
                         for _ in range(40)]
    got, want = M.signed_digits(scal, order, c_bits), \
        jax_signed_digits(scal, order, c_bits)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name,n", [("bn254-g1", 1), ("bn254-g1", 7),
                                    ("bn254-g1", 64), ("grumpkin", 1),
                                    ("grumpkin", 7), ("grumpkin", 64),
                                    ("pallas", 7)])
def test_msm_plain_matches_jax_pippenger(name, n):
    curve, jcurve = CURVES[name]
    scal, pts = scalars_and_points(curve, n, seed=n)
    table = M.MsmTable.build(curve, pts, "cpu")
    launches = M.launches
    got = table.msm(scal)
    assert M.launches == launches            # the CPU runs the plain version
    assert got == jcurve.pippenger(scal, pts)


def witness(n: int, seed: int) -> list:
    """Witness-sized scalars (below 2^64): the commit tests are about
    routing; full-width scalars are covered above."""
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 1 << 63, size=n)]


@pytest.mark.parametrize("n", [64, 200])
def test_commitment_key_matches_jax(n, tmp_path, monkeypatch):
    """setup (hash-derived generators, the prover's label), a CPU key's
    host C++ route at n and its Python route below 64, against the JAX
    key's host route over the same generators (their derivation is held against
    the JAX package's in test_torch_curves.py)."""
    monkeypatch.setattr(params_cache, "cache_dir", lambda: tmp_path)
    label = b"lurk_tpu.ck.grumpkin"
    key = nova.CommitmentKey.setup(W.GRUMPKIN, label, n, "cpu")
    assert key.gens == W.GRUMPKIN.derive_generators_from(label, 0, n)
    assert key.device.type == "cpu"
    jkey = JaxCommitmentKey(JW.GRUMPKIN, key.gens)
    vec = witness(n, seed=n)
    assert key.commit(vec) == jkey.commit(vec)
    assert key.commit(vec[:10]) == jkey.commit(vec[:10])
    assert key.commit_async(vec[:10])() == jkey.commit(vec[:10])


def test_table_from_jax_key_bytes():
    """A JAX key's generators, in its params-cache byte layout, become
    the port's table unchanged, and commit to the JAX key's point."""
    gens = W.BN254_G1.derive_generators_from(b"carried", 0, 70)
    data = jax_params_cache._gens_to_bytes(gens)
    table = M.table_from_bytes(W.BN254_G1, data, "cpu")
    assert table.n_points == 70 and table.n == 128
    assert torch.equal(table.rows,
                       M.MsmTable.build(W.BN254_G1, gens, "cpu").rows)
    vec = witness(70, seed=3)
    assert table.msm(vec) == JaxCommitmentKey(JW.BN254_G1, gens).commit(vec)


def test_wrapper_checks_its_inputs():
    table = M.MsmTable.build(W.BN254_G1, [W.BN254_G1.generator], "cpu")
    with pytest.raises(ValueError):
        M.msm_words(table, torch.zeros((table.n, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        M.msm_words(table, torch.zeros((table.n - 1, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        table.msm([1, 2])
    key = nova.CommitmentKey(W.BN254_G1, [W.BN254_G1.generator], "cpu")
    with pytest.raises(ValueError):
        key.commit([1, 2])
    with pytest.raises(ValueError):
        M.table_from_bytes(W.BN254_G1, b"\0" * 65)


def test_commitment_key_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        nova.CommitmentKey(W.BN254_G1, [W.BN254_G1.generator])
