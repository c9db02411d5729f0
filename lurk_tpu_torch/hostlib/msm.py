"""ctypes wrapper for the host Pippenger MSM (``csrc/host/msm.cpp``).

The commitment route of a CPU key (:class:`..proof.nova.CommitmentKey`
with ``device="cpu"``), as the JAX package's ``native/msm.py`` is its
route without a device; a CUDA key commits through the MSM kernel. The
oracle is :meth:`..curves.weierstrass.Curve.pippenger`.
"""

from __future__ import annotations

import ctypes
import math
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


def window_bits(n: int) -> int:
    """The JAX package's window width for n scalars."""
    return 3 if n < 32 else min(16, max(4, int(math.log2(n)) - 2))


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
    lib.lurk_msm(mod.ctypes.data, rsq.ctypes.data, pts.ctypes.data,
                 scs.ctypes.data, n, window_bits(n),
                 min(32, os.cpu_count() or 1), curve.scalar.num_bits,
                 out.ctypes.data)
    x, y, z = (sum(int(w) << (64 * i) for i, w in enumerate(out[k:k + 4]))
               for k in (0, 4, 8))
    return None if z == 0 else curve.jac_to_affine((x, y, z))
