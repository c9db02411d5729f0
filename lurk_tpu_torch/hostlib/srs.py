"""ctypes wrapper for host powers-of-tau SRS generation
(``csrc/host/srs.cpp``), a copy of the JAX package's ``native/srs.py``.

Oracle: ``proof/hyperkzg.py:_fixed_base_mul`` over the Python curve,
about 1.5 ms per point there; threaded window adds and one batch
inversion per thread here."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import native
from . import r2, to_limbs


def srs_limbs(curve, tau: int, start: int, n: int) -> np.ndarray:
    """``uint64[n, 8]`` canonical affine (x, y) limbs of tau^i * G for
    i in [start, start + n); raises if the library cannot be built."""
    lib = native.load_host("srs")
    out = np.zeros((max(0, n), 8), dtype=np.uint64)
    if n <= 0:
        return out
    gx, gy = curve.generator
    gen = np.concatenate([to_limbs(gx), to_limbs(gy)])
    tau_l = to_limbs(tau % curve.order)
    bmod, omod = to_limbs(curve.p), to_limbs(curve.order)
    br2, or2 = r2(curve.p), r2(curve.order)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.lurk_srs_powers.restype = None
    lib.lurk_srs_powers(
        bmod.ctypes.data_as(u64p), br2.ctypes.data_as(u64p),
        omod.ctypes.data_as(u64p), or2.ctypes.data_as(u64p),
        gen.ctypes.data_as(u64p), tau_l.ctypes.data_as(u64p),
        ctypes.c_uint64(start), ctypes.c_uint64(n),
        out.ctypes.data_as(u64p),
        ctypes.c_int(min(32, os.cpu_count() or 1)))
    return out
