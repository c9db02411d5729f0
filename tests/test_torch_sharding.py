"""The port's sharded prover layer (lurk_tpu_torch.parallel.sharding) over
two CPU devices against the JAX package's host paths, exact.

Shards on the CPU run the kernels' plain versions: the dense Poseidon
per shard, the MSM per shard with the partial points summed on the host.
The JAX side is ``hash_preimage``, the Python ``Curve.pippenger`` and
``Store(..., use_device=False)``; its mesh paths are not run (their
XLA:CPU compiles take minutes).
"""

import numpy as np
import pytest
import torch

from lurk_tpu.curves import weierstrass as JW
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.native import msm as jax_native_msm
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.poseidon.host import hash_preimage as jax_hash_preimage
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.curves import weierstrass as W
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.parallel import sharding
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.poseidon import kernel as K
from lurk_tpu_torch.proof.nova import CommitmentKey
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def two_cpus(monkeypatch):
    devices = [CPU, CPU]
    monkeypatch.setattr(sharding, "_PROVER_DEVICES", devices)
    monkeypatch.setattr(jax_native_msm, "available", lambda: False)
    return devices


@pytest.mark.parametrize("flag,want", [("0", None), ("2", None), ("", None)])
def test_prover_devices_reads_lurk_tpu_mesh(monkeypatch, flag, want):
    """Without several CUDA devices nothing is sharded, whatever the
    flag; the answer is cached."""
    if torch.cuda.device_count() > 1:
        pytest.skip("several CUDA devices are present")
    monkeypatch.setattr(sharding, "_PROVER_DEVICES", sharding._UNSET)
    monkeypatch.setenv("LURK_TPU_MESH", flag)
    assert sharding.prover_devices() is want
    assert sharding._PROVER_DEVICES is want


def test_shard_hash_batch_ints_matches_host(two_cpus):
    rng = np.random.default_rng(5)
    p = BN256_SCALAR.modulus
    pres = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(4)]
            for _ in range(130)] + [[0] * 4, [p - 1] * 4]
    got = sharding.shard_hash_batch_ints(two_cpus, BN256_SCALAR, 4, pres)
    assert got == [jax_hash_preimage(JAX_BN256, pre) for pre in pres]
    x = K.preimages_to_tensor(BN256_SCALAR, 4, pres[:3], "cpu")
    with pytest.raises(ValueError):                 # 3 lanes on 2 shards
        sharding.shard_hash_batch(two_cpus, BN256_SCALAR, 4, x)


def test_sharded_msm_matches_jax_pippenger(two_cpus):
    """n = 100 over two shards of 64, with witness-sized scalars (below
    2^64; full-width ones are held in test_torch_msm.py): the table,
    CommitmentKey.commit routed to the shards, and the one-shot call."""
    rng = np.random.default_rng(8)
    curve = W.BN254_G1
    pts = curve.derive_generators_from(b"test_torch_sharding", 0, 100)
    scal = [int(v) for v in rng.integers(0, 1 << 63, size=100)]
    table = sharding.ShardedMsmTable(two_cpus, curve, pts)
    assert table.per == 64 and [s.n_points for s in table.shards] == [64, 36]
    assert table.msm(scal) == JW.BN254_G1.pippenger(scal, pts)
    key = CommitmentKey(curve, pts, "cpu")
    assert key.commit(scal[:70]) == JW.BN254_G1.pippenger(scal[:70],
                                                          pts[:70])
    assert key.sharded_table(two_cpus).per == 64
    assert sharding.shard_msm(two_cpus, curve, scal[:3], pts) == \
        JW.BN254_G1.pippenger(scal[:3], pts[:3])


def test_sharded_hydration_matches_jax(two_cpus, monkeypatch):
    """A small program and a wave of 96 conses in one store: the wide
    wave goes to the shards, the small ones to the host hash; z-ptrs
    equal the JAX store's."""
    waves = []
    shard_ints = sharding.shard_hash_batch_ints

    def spy(devices, field, arity, pres):
        waves.append((arity, len(pres)))
        return shard_ints(devices, field, arity, pres)

    monkeypatch.setattr(sharding, "shard_hash_batch_ints", spy)
    src = "(let ((make-adder (lambda (x) (lambda (y) (+ x y))))) " \
          "((make-adder 2) 3))"
    store = Store(BN256_SCALAR, device="cpu")
    jstore = JaxStore(JAX_BN256, use_device=False)
    ptrs = [read_with_default_state(store, src)]
    jptrs = [jax_read(jstore, src)]
    for v in range(96):
        ptrs.append(store.cons(store.num(v), store.num(v + 1)))
        jptrs.append(jstore.cons(jstore.num(v), jstore.num(v + 1)))
    store.hydrate_z_cache()
    jstore.hydrate_z_cache()
    assert waves and all(n >= 64 for _, n in waves)
    assert [tuple(store.hash_ptr(p)) for p in ptrs] == \
        [tuple(jstore.hash_ptr(p)) for p in jptrs]
