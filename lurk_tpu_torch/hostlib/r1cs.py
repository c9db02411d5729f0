"""ctypes wrapper for the host sparse R1CS kernels (``csrc/host/r1cs.cpp``).

A copy of the JAX package's ``native/r1cs.py``. It is the port's only
route for the fold's matvecs, cross-term, relaxed check and witness
folds, and for the compression's padded matvecs
(``matvecs_padded_pv``): there is no Python path, and a failed build
raises. The oracle is the JAX package's Python loops (its
``proof/nova.py``), held in ``tests/test_torch_fold.py``.

Shapes register once per process keyed by their digest and field; z
vectors cross the boundary as packed 4 x 64-bit little-endian limbs
(:class:`PackedVec`, packed by :mod:`.fastpack`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native
from . import r2, to_limbs
from .fastpack import lc_matrix, pack_ints, unpack_ints

_HANDLES: Dict[Tuple[str, int], int] = {}


def _canonical(limbs: np.ndarray, p: int) -> np.ndarray:
    """Packed limbs with each value of p or more reduced mod p."""
    v = limbs.reshape(-1, 4)
    below = np.zeros(len(v), dtype=bool)      # v < p, decided from the top
    equal = np.ones(len(v), dtype=bool)
    for i in (3, 2, 1, 0):
        pi = np.uint64((p >> (64 * i)) & ((1 << 64) - 1))
        below |= equal & (v[:, i] < pi)
        equal &= v[:, i] == pi
    hit = np.flatnonzero(~below)
    if not hit.size:
        return limbs
    vals = unpack_ints(v[hit].reshape(-1), hit.size)
    limbs = limbs.copy()
    limbs.reshape(-1, 4)[hit] = pack_ints([x % p for x in vals]).reshape(-1, 4)
    return limbs


def _pack_vec(vec: Sequence[int], p: int) -> np.ndarray:
    """Canonical (< p) packed limbs of ``vec``; a vector holding a
    negative value or one of 2^256 or more is reduced whole first."""
    vals = vec if isinstance(vec, (list, tuple)) else list(vec)
    try:
        arr = pack_ints(vals)
    except OverflowError:
        return pack_ints([int(v) % p for v in vals])
    return _canonical(arr, p)


class PackedVec:
    """A field vector held as packed limbs (``arr``: C-contiguous
    ``uint64[4n]``, canonical, little-endian). Keeps the prover's
    accumulators and step vectors native-resident; iteration and
    indexing unpack lazily (cached) for the cold paths."""

    __slots__ = ("arr", "n", "p", "_ints")

    def __init__(self, arr: np.ndarray, n: int, p: int):
        self.arr = arr
        self.n = n
        self.p = p
        self._ints = None

    @staticmethod
    def pack(vec, p: int) -> "PackedVec":
        if isinstance(vec, PackedVec):
            if vec.p != p:
                raise ValueError(f"a vector over {vec.p} is not over {p}")
            return vec
        return PackedVec(_pack_vec(vec, p), len(vec), p)

    @staticmethod
    def zeros(n: int, p: int) -> "PackedVec":
        return PackedVec(np.zeros(4 * n, dtype=np.uint64), n, p)

    def ints(self) -> List[int]:
        if self._ints is None:
            self._ints = unpack_ints(self.arr, self.n)
        return self._ints

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self.ints())

    def __getitem__(self, i):
        return self.ints()[i]

    def __setitem__(self, i, v):
        vals = list(self.ints())
        vals[i] = v
        self.arr = _pack_vec(vals, self.p)
        self._ints = None


def _as_packed(vec, p: int) -> np.ndarray:
    return PackedVec.pack(vec, p).arr


def pv_concat(head: Sequence[int], tail, p: int) -> PackedVec:
    """PackedVec of (head ints ++ tail vector)."""
    ha = _pack_vec([int(v) % p for v in head], p)
    ta = _as_packed(tail, p)
    return PackedVec(np.concatenate([ha, ta]), len(head) + len(tail), p)


def pad_pv(vec, n: int, p: int) -> PackedVec:
    """Zero-pad a vector to length n as a PackedVec."""
    arr = _as_packed(vec, p)
    m = len(vec)
    if m > n:
        raise ValueError(f"a vector of {m} does not fit in {n}")
    if m == n:
        return PackedVec(arr, n, p)
    return PackedVec(
        np.concatenate([arr, np.zeros(4 * (n - m), dtype=np.uint64)]), n, p)


def _lib() -> ctypes.CDLL:
    lib = native.load_host("r1cs")
    v, u64, i, ll = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                     ctypes.c_long)
    lib.lurk_r1cs_shape.argtypes = [v, v, u64, u64] + [v] * 9
    lib.lurk_r1cs_shape.restype = ll
    lib.lurk_r1cs_matvecs.argtypes = [ll, v, i, v]
    lib.lurk_r1cs_matvecs.restype = None
    lib.lurk_r1cs_cross_term.argtypes = [ll, v, v, v, i, v]
    lib.lurk_r1cs_cross_term.restype = None
    lib.lurk_r1cs_cross_term_cached.argtypes = [ll, v, v, v, i, v, v]
    lib.lurk_r1cs_cross_term_cached.restype = None
    lib.lurk_r1cs_check_relaxed.argtypes = [ll, v, v, v, i]
    lib.lurk_r1cs_check_relaxed.restype = u64
    lib.lurk_vec_rlc.argtypes = [v, v, v, v, v, u64, i, v]
    lib.lurk_vec_rlc.restype = None
    return lib


def csr_and_digest(rows, num_inputs: int, num_aux: int, p: int):
    """The A, B and C matrices of LC-dict rows as CSR (``uint64`` indptr
    and column indices, canonical coefficient limbs) and the digest of
    ``ConstraintSystem.shape_digest`` (the JAX package's), from one walk
    of the rows in C++ (``lc_matrix``): the digest's byte stream (per
    row, each LC's entries as 4 + 32 little-endian bytes closed by
    ``|``, the row closed by ``;``) is laid out with numpy and hashed
    once."""
    rows = list(rows)
    m = len(rows)
    csr, entries, counts = [], [], []
    for k in range(3):
        cnt, cols, raw = lc_matrix(rows, k)
        # the digest hashes the coefficients as the rows hold them
        ent = np.empty((cols.size, 36), dtype=np.uint8)
        ent[:, :4] = cols.astype("<u4").view(np.uint8).reshape(-1, 4)
        ent[:, 4:] = raw.view(np.uint8).reshape(-1, 32)
        entries.append(ent)
        counts.append(cnt)
        indptr = np.zeros(m + 1, dtype=np.uint64)
        np.cumsum(cnt, out=indptr[1:])
        csr.append((indptr, cols, _canonical(raw, p)))
    # the entries in stream order (row by row, A, B, C in each), then
    # "|" after each LC and ";" after each row's last "|"
    group = [np.repeat(np.arange(m, dtype=np.int64) * 3 + k, counts[k])
             for k in range(3)]
    order = np.argsort(np.concatenate(group), kind="stable")
    stream = np.concatenate(entries)[order].reshape(-1)
    ends = 36 * np.cumsum(np.stack(counts, axis=1).reshape(-1))
    at = np.repeat(ends, np.tile([1, 1, 2], m))
    marks = np.tile(np.frombuffer(b"|||;", dtype=np.uint8), m)
    h = hashlib.sha256(f"{num_inputs}:{num_aux}".encode())
    h.update(np.insert(stream, at, marks).data)
    return csr, h.hexdigest()


def handle_for(shape) -> int:
    """Register (once) and return the host handle of a
    :class:`..proof.nova.R1CSShape`. The same structure over two fields
    must not share a handle, so the key is (digest, p)."""
    key = (shape.digest, shape.p)
    h = _HANDLES.get(key)
    if h is not None:
        return h
    p = shape.p
    mod, rsq = to_limbs(p), r2(p)
    keep = shape.csr()               # alive until the library copied it
    args = [a.ctypes.data for mats in keep for a in mats]
    h = _lib().lurk_r1cs_shape(
        mod.ctypes.data, rsq.ctypes.data, shape.num_constraints,
        shape.num_inputs + shape.num_aux, *args)
    _HANDLES[key] = h
    return h


def _threads() -> int:
    return min(32, os.cpu_count() or 1)


def _check_z(shape, z) -> np.ndarray:
    zp = _as_packed(z, shape.p)
    if zp.size != 4 * (shape.num_inputs + shape.num_aux):
        raise ValueError(f"z of {zp.size // 4} values for a shape of "
                         f"{shape.num_inputs + shape.num_aux} variables")
    return zp


def _check_len(vec: np.ndarray, n: int, what: str) -> np.ndarray:
    if vec.size != 4 * n:
        raise ValueError(f"{what} of {vec.size // 4} values, expected {n}")
    return vec


def matvecs_pv(shape, z) -> PackedVec:
    """(Az | Bz | Cz) as one packed 3m vector."""
    h = handle_for(shape)
    m = shape.num_constraints
    zp = _check_z(shape, z)
    out = np.zeros(3 * m * 4, dtype=np.uint64)
    _lib().lurk_r1cs_matvecs(h, zp.ctypes.data, _threads(), out.ctypes.data)
    return PackedVec(out, 3 * m, shape.p)


def matvecs_padded_pv(shape, z, m_pad: int
                      ) -> Tuple[PackedVec, PackedVec, PackedVec]:
    """(Az, Bz, Cz) as three PackedVecs zero-padded to ``m_pad`` (the
    compression's sumcheck input, with no int round-trip)."""
    m = shape.num_constraints
    out = matvecs_pv(shape, z).arr
    pad = np.zeros(4 * (m_pad - m), dtype=np.uint64)
    return tuple(
        PackedVec(np.concatenate([out[4 * m * k:4 * m * (k + 1)], pad]),
                  m_pad, shape.p)
        for k in range(3))


def matvecs(shape, z) -> Tuple[List[int], List[int], List[int]]:
    """(Az, Bz, Cz) as int lists."""
    m = shape.num_constraints
    abc = matvecs_pv(shape, z).ints()
    return abc[:m], abc[m:2 * m], abc[2 * m:]


def cross_term_pv(shape, z1, u1: int, z2) -> PackedVec:
    """T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − Cz1 (z2 strict, u2 = 1)."""
    h = handle_for(shape)
    m = shape.num_constraints
    p = shape.p
    z1p, z2p = _check_z(shape, z1), _check_z(shape, z2)
    u1p = to_limbs(u1 % p)
    out = np.zeros(m * 4, dtype=np.uint64)
    _lib().lurk_r1cs_cross_term(h, z1p.ctypes.data, u1p.ctypes.data,
                                z2p.ctypes.data, _threads(),
                                out.ctypes.data)
    return PackedVec(out, m, p)


def cross_term(shape, z1, u1: int, z2) -> List[int]:
    return cross_term_pv(shape, z1, u1, z2).ints()


def cross_term_cached(shape, abc1, u1: int, z2):
    """Cross term from cached accumulator matvecs.

    abc1: (Az1 | Bz1 | Cz1) (3m elements). Returns (t: PackedVec[m],
    abc2: PackedVec[3m]); abc2 lets the caller fold the cache forward
    (abc1' = abc1 + r * abc2, since z folds linearly)."""
    h = handle_for(shape)
    m = shape.num_constraints
    p = shape.p
    a1 = _check_len(_as_packed(abc1, p), 3 * m, "abc1")
    z2p = _check_z(shape, z2)
    u1p = to_limbs(u1 % p)
    out_t = np.zeros(m * 4, dtype=np.uint64)
    out2 = np.zeros(3 * m * 4, dtype=np.uint64)
    _lib().lurk_r1cs_cross_term_cached(
        h, a1.ctypes.data, u1p.ctypes.data, z2p.ctypes.data, _threads(),
        out_t.ctypes.data, out2.ctypes.data)
    return PackedVec(out_t, m, p), PackedVec(out2, 3 * m, p)


def check_relaxed(shape, z, u: int, e) -> bool:
    """Az∘Bz = u·Cz + E on every row."""
    h = handle_for(shape)
    p = shape.p
    zp = _check_z(shape, z)
    ep = _check_len(_as_packed(e, p), shape.num_constraints, "E")
    up = to_limbs(u % p)
    bad = _lib().lurk_r1cs_check_relaxed(h, zp.ctypes.data, up.ctypes.data,
                                         ep.ctypes.data, _threads())
    return bad == 0


def vec_rlc_pv(p: int, a, b, r: int) -> PackedVec:
    """a + r*b mod p elementwise (the fold's witness and error RLC)."""
    n = len(a)
    if len(b) != n:
        raise ValueError(f"vectors of {n} and {len(b)} values")
    ap, bp = _as_packed(a, p), _as_packed(b, p)
    mod, rsq, rp = to_limbs(p), r2(p), to_limbs(r % p)
    out = np.zeros(4 * n, dtype=np.uint64)
    _lib().lurk_vec_rlc(mod.ctypes.data, rsq.ctypes.data, ap.ctypes.data,
                        bp.ctypes.data, rp.ctypes.data, n, _threads(),
                        out.ctypes.data)
    return PackedVec(out, n, p)


def vec_rlc(p: int, a, b, r: int) -> List[int]:
    return vec_rlc_pv(p, a, b, r).ints()
