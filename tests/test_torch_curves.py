"""The port's curves, generators, params cache and SRS against the JAX
package's, exact (points are integers; tolerance none).

The JAX side's Pedersen derivation of 64 or more points runs its host
C++ (``lurk_tpu/native/pedersen.cpp``), as the port's runs its copy.
Its SRS is taken on its Python fixed-base path (``native.srs`` reported
unavailable), an independent oracle of the port's host C++ SRS.
"""

import numpy as np
import pytest

from lurk_tpu.curves import weierstrass as JW
from lurk_tpu.native import srs as jax_native_srs
from lurk_tpu.proof import hyperkzg as jax_hyperkzg
from lurk_tpu.proof.params_cache import _gens_to_bytes as jax_gens_to_bytes
from lurk_tpu_torch.curves import weierstrass as W
from lurk_tpu_torch.proof import hyperkzg, params_cache
from test_torch_field import one_torch_thread  # noqa: F401

NAMES = ["PALLAS", "VESTA", "BN254_G1", "GRUMPKIN"]


def curves(name):
    return getattr(W, name), getattr(JW, name)


@pytest.mark.parametrize("name", NAMES)
def test_group_law_mul_and_pippenger_match_jax(name):
    c, jc = curves(name)
    assert (c.name, c.p, c.order, c.b, c.generator) == \
        (jc.name, jc.p, jc.order, jc.b, jc.generator)
    rng = np.random.default_rng(len(name))
    ks = [int.from_bytes(rng.bytes(32), "little") for _ in range(6)]
    pts = [c.mul(k, c.generator) for k in ks]
    assert pts == [jc.mul(k, jc.generator) for k in ks]
    assert all(c.is_on_curve(p) for p in pts)
    a, b = pts[0], pts[1]
    assert c.add(a, b) == jc.add(a, b)
    assert c.double(a) == jc.double(a) == c.add(a, a)
    assert c.add(a, c.neg(a)) is None and c.add(None, b) == b
    scalars = ks[:4] + [0, c.order - 1]
    assert c.pippenger(scalars, pts) == jc.pippenger(scalars, pts) \
        == c.msm(scalars, pts)


@pytest.mark.parametrize("name", NAMES)
def test_generators_match_jax(name):
    """n = 8 on the Python paths, n = 64 on the host C++ of both."""
    c, jc = curves(name)
    assert c.derive_generators_from(b"lbl", 3, 11) == \
        jc.derive_generators_from(b"lbl", 3, 11)
    assert c.derive_generators_from(b"lbl", 0, 64) == \
        jc.derive_generators_from(b"lbl", 0, 64)


def test_params_cache_grows_in_the_jax_layout(tmp_path, monkeypatch):
    monkeypatch.setattr(params_cache, "cache_dir", lambda: tmp_path)
    first = params_cache.load_generators(W.GRUMPKIN, b"x", 70)
    grown = params_cache.load_generators(W.GRUMPKIN, b"x", 100)
    assert grown[:70] == first
    assert grown == JW.GRUMPKIN.derive_generators_from(b"x", 0, 100)
    data = (tmp_path / f"ck_grumpkin_{b'x'.hex()}.bin").read_bytes()
    assert data == jax_gens_to_bytes(grown)
    assert params_cache._gens_to_bytes(grown) == data
    assert params_cache._gens_from_bytes(data, 100) == grown
    assert params_cache.load_generators(W.GRUMPKIN, b"x", 50) == grown[:50]


def test_srs_prefix_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(params_cache, "cache_dir", lambda: tmp_path)
    monkeypatch.setattr(hyperkzg, "_SRS_MEM", {})
    monkeypatch.setattr(jax_hyperkzg, "_SRS_MEM", {})
    monkeypatch.setattr(jax_native_srs, "available", lambda: False)
    srs = hyperkzg.load_srs(64)
    want = jax_hyperkzg.load_srs(64)
    assert srs.powers == want.powers[:64]
    assert srs.tau_g2 == want.tau_g2 and srs.g2 == want.g2
    assert hyperkzg.load_srs(32) is srs          # served from memory
    grown = hyperkzg._load_srs_disk(80)          # extends the disk cache
    assert grown.powers[:64] == srs.powers
    assert grown.powers[79] == hyperkzg._fixed_base_mul(
        *hyperkzg._fixed_base_mul_table(W.BN254_G1.generator),
        pow(hyperkzg._tau(), 79, W.BN254_G1.order))
