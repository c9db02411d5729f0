"""The frozen bound arithmetic against ``chip_smoke.py``'s functions,
on seeded words."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.harness import bounds
from benchmark.reference.poseidon import round_numbers


@pytest.mark.parametrize("arity", [3, 4, 6, 8])
def test_imad_per_hash(arity):
    from lurk_tpu_torch.fields import BN256_SCALAR
    t = arity + 1
    assert bounds.imad_per_hash(t, *round_numbers(t)) == \
        chip_smoke.imad_per_hash(BN256_SCALAR, arity)


def test_constants():
    for name in ("HBM_BYTES_PER_S", "IMAD_PER_CLK_PER_SM", "PRODUCT",
                 "SQUARE", "REDC", "MUL", "REDC_WIDE", "MADD", "ADD",
                 "MSM_BOUND_MAX_C"):
        assert getattr(bounds, name) == getattr(chip_smoke, name), name


def _words(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w[:, 7] &= 0x0FFFFFFF                    # below 2^252
    w[rng.random(n) < 0.3] = 0                # W-like: many zeros
    w[rng.random(n) < 0.2, 1:] = 0            # and small values
    return w.astype(np.uint32)


@pytest.mark.parametrize("c", [1, 5, 13, 16, 22])
def test_msm_digits(c):
    w = torch.from_numpy(_words(c, 300).astype(np.int64))
    assert torch.equal(bounds.msm_digits(w, c), chip_smoke.msm_digits(w, c))


@pytest.mark.parametrize("seed", [1, 2])
def test_least_msm_work_and_bound(seed):
    # chip_smoke's least_msm_work counts on "cuda"; here its body runs on
    # the CPU
    src = inspect.getsource(chip_smoke.least_msm_work).replace(
        '"cuda"', '"cpu"')
    scope = dict(vars(chip_smoke))
    exec(src, scope)
    words = _words(seed, 2000)
    assert bounds.least_msm_work(words, "cpu") == \
        scope["least_msm_work"](words)
    ours = bounds.Bound(132, 1980)
    theirs = chip_smoke.Bound(132, 1980)
    assert ours._max(1e9, 1e6) == theirs._max(1e9, 1e6)
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.poseidon.spec import poseidon_spec
    spec = poseidon_spec(BN256_SCALAR, 4)
    assert ours.of(5, *round_numbers(5), 344)[0] == pytest.approx(
        theirs.of(BN256_SCALAR, 4, 344, 0)[0], rel=1e-3)
    assert spec.width == 5
