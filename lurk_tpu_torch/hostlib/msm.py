"""ctypes wrapper for the host Pippenger MSM (``csrc/host/msm.cpp``).

The commitment route of a CPU key (:class:`..proof.nova.CommitmentKey`
with ``device="cpu"``), as the JAX package's ``native/msm.py`` is its
route without a device; a CUDA key commits through the MSM kernel. The
oracle is :meth:`..curves.weierstrass.Curve.pippenger`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from .. import native
from ..curves.weierstrass import Affine, Curve
from ..msm.kernel import points_to_words
from . import r2, to_limbs


def pack_points(points: Sequence[Affine]) -> np.ndarray:
    """``uint64[n, 8]`` canonical (x, y) limbs; the point at infinity
    is (0, 0)."""
    return points_to_words(points).view(np.uint64).reshape(len(points), 8)


def window_bits(n: int, scalar_bits: int) -> int:
    """The window width of least work for n non-zero scalars: in each
    of the ceil(bits / c) windows a mixed addition a scalar (about 11
    field products) and two full additions a bucket for the running sums
    (about 16 each). The JAX package takes log2(n) - 2 whatever the
    zeros, which at an IPA round's 2^15 scalars, half of them 0, does
    about a third more work; the point is the same at any width."""
    if n < 32:
        return 3
    return min(range(4, 17), key=lambda c: -(-scalar_bits // c)
               * (11 * n + 32 * ((1 << c) - 1)))


def msm(curve: Curve, scalars: np.ndarray, points: np.ndarray) -> Affine:
    """Σ s_i P_i for canonical scalar limbs ``uint64[4n]`` (below the
    group order) and packed points ``uint64[>= n, 8]``."""
    n = scalars.size // 4
    if points.shape[0] < n:
        raise ValueError(f"{n} scalars for {points.shape[0]} points")
    if n == 0:
        return None
    lib = native.load_host("msm")
    v = ctypes.c_void_p
    lib.lurk_msm.argtypes = [v, v, v, v, ctypes.c_size_t, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, v]
    lib.lurk_msm.restype = None
    mod, rsq = to_limbs(curve.p), r2(curve.p)
    pts = np.ascontiguousarray(points[:n], dtype=np.uint64)
    scs = np.ascontiguousarray(scalars, dtype=np.uint64)
    out = np.zeros(12, dtype=np.uint64)
    nonzero = int(np.count_nonzero(scs.reshape(n, 4).any(axis=1)))
    bits = curve.scalar.num_bits
    lib.lurk_msm(mod.ctypes.data, rsq.ctypes.data, pts.ctypes.data,
                 scs.ctypes.data, n, window_bits(nonzero, bits),
                 min(32, os.cpu_count() or 1), bits, out.ctypes.data)
    x, y, z = (sum(int(w) << (64 * i) for i, w in enumerate(out[k:k + 4]))
               for k in (0, 4, 8))
    return None if z == 0 else curve.jac_to_affine((x, y, z))
