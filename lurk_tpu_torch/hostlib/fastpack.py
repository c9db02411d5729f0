"""Bulk Python int <-> packed limb conversion (``csrc/host/fastpack.cpp``).

The counterpart of the JAX package's ``native/fastpack.py``: a vector of
ints in [0, 2^256) becomes ``uint64[4n]`` (4 little-endian 64-bit limbs
per value, the layout of the host R1CS and MSM, and, viewed as
``uint32[n, 8]``, of the MSM kernel's scalars) and back, through the
CPython big-int API. There is no Python path: without g++ or the
interpreter's headers, building raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from .. import native


def _lib():
    lib = native.load_host("fastpack", loader=ctypes.PyDLL)
    lib.lurk_pack_ints.argtypes = [ctypes.py_object, ctypes.c_void_p]
    lib.lurk_pack_ints.restype = ctypes.c_int
    lib.lurk_unpack_ints.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t,
                                     ctypes.py_object]
    lib.lurk_unpack_ints.restype = ctypes.c_int
    lib.lurk_lc_matrix.argtypes = [ctypes.py_object, ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_ssize_t]
    lib.lurk_lc_matrix.restype = ctypes.c_ssize_t
    return lib


def pack_ints(values: Sequence[int]) -> np.ndarray:
    """``uint64[4 len(values)]``; raises OverflowError for a value that
    is negative or 2^256 or more, TypeError for one that is not an
    int."""
    vals = values if isinstance(values, (list, tuple)) else list(values)
    out = np.empty(4 * len(vals), dtype=np.uint64)
    _lib().lurk_pack_ints(vals, out.ctypes.data)
    return out


def unpack_ints(limbs: np.ndarray, n: int) -> List[int]:
    """The first ``n`` values of packed limbs, as ints."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint64)
    if arr.size < 4 * n:
        raise ValueError(f"{arr.size} limbs hold fewer than {n} values")
    out: List[int] = [None] * n
    _lib().lurk_unpack_ints(arr.ctypes.data, n, out)
    return out


def lc_matrix(rows: list, which: int):
    """Matrix ``which`` (0, 1, 2: A, B, C) of R1CS rows (a list of
    ``(A, B, C)`` tuples of ``{variable: coefficient}`` dicts): ``int64``
    entries per row, then the rows' variables, each LC's in ascending
    order, as ``uint64``, and their coefficients as the dicts hold them,
    packed (``uint64[4 n]``)."""
    lib = _lib()
    counts = np.empty(len(rows), dtype=np.int64)
    n = lib.lurk_lc_matrix(rows, which, counts.ctypes.data, None, None, 0)
    cols = np.empty(n, dtype=np.uint64)
    coefs = np.empty(4 * n, dtype=np.uint64)
    lib.lurk_lc_matrix(rows, which, counts.ctypes.data, cols.ctypes.data,
                       coefs.ctypes.data, n)
    return counts, cols, coefs
