"""ctypes wrapper for the host Pedersen generator derivation
(``csrc/host/pedersen.cpp``), a copy of the JAX package's
``native/pedersen.py``.

Oracle: :meth:`lurk_tpu_torch.curves.weierstrass.Curve.derive_generators_from`
(pure Python shake256 try-and-increment); bit-exact, threaded. The
Python path costs about 1.5 ms per point; a 2^21-point key would take
most of an hour there."""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from .. import native
from . import points_from_limbs, r2, to_limbs


def derive_limbs(curve, label: bytes, start: int, end: int) -> np.ndarray:
    """``uint64[end - start, 8]`` canonical (x, y) limbs of the
    generators for indices [start, end); raises if the library cannot
    be built or derivation fails."""
    lib = native.load_host("pedersen")
    n = max(0, end - start)
    out = np.zeros((n, 8), dtype=np.uint64)
    if n == 0:
        return out
    mod = to_limbs(curve.p)
    rsq = r2(curve.p)
    b = to_limbs(curve.b % curve.p)
    lab = np.frombuffer(label, dtype=np.uint8) if label else \
        np.zeros(0, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.derive_generators.restype = ctypes.c_int
    rc = lib.derive_generators(
        mod.ctypes.data_as(u64p), rsq.ctypes.data_as(u64p),
        b.ctypes.data_as(u64p),
        lab.ctypes.data_as(u8p), ctypes.c_int64(len(label)),
        ctypes.c_int64(start), ctypes.c_int64(end),
        out.ctypes.data_as(u64p),
        ctypes.c_int(min(32, os.cpu_count() or 1)))
    if rc != 0:
        raise RuntimeError(f"generator derivation failed (code {rc})")
    return out


def derive_generators_from(curve, label: bytes, start: int,
                           end: int) -> List[Tuple[int, int]]:
    """[(x, y)] for indices [start, end)."""
    return points_from_limbs(derive_limbs(curve, label, start, end))
