"""Relaxed R1CS on Python integers: (A z) o (B z) = u (C z) + E with
z = (u | x | W), the matrices as CSR (row pointers, columns,
coefficients as little-endian 64-bit limbs). The products run on NumPy
arrays of Python integers, a block of rows at a time."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

BLOCK_ROWS = 1 << 16


def _mix(flat: np.ndarray) -> np.ndarray:
    """A 64-bit key of each row of limbs (splitmix64 of each limb, with
    its position, xored)."""
    key = np.zeros(flat.shape[0], dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in range(flat.shape[1]):
            z = flat[:, i] + np.uint64((i + 1) * 0x9E3779B97F4A7C15
                                       % (1 << 64))
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            key ^= z ^ (z >> np.uint64(31))
    return key


def ints_from_limbs(arr: np.ndarray) -> List[int]:
    """uint64[4n] or uint64[n, 4] little-endian limbs -> n integers."""
    raw = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def compact(csr) -> list:
    """The matrices with each distinct coefficient once: (row pointers,
    columns, distinct limbs, index of each entry's coefficient), grouped
    by a 64-bit mix of the limbs and every member then compared limb by
    limb with its group's first (all kept apart where one differs)."""
    out = []
    for indptr, cols, limbs in csr:
        flat = np.ascontiguousarray(limbs, dtype="<u8").reshape(-1, 4)
        index = np.arange(flat.shape[0], dtype=np.int64)
        uniq = flat
        if flat.shape[0]:
            _, first, inverse = np.unique(_mix(flat), return_index=True,
                                          return_inverse=True)
            inverse = inverse.reshape(-1)
            if (flat == flat[first[inverse]]).all():
                uniq, index = flat[first], inverse
        out.append((np.asarray(indptr, dtype=np.int64),
                    np.asarray(cols, dtype=np.int32), uniq,
                    index.astype(np.int32)))
    return out


def prepare(mats) -> list:
    """``compact``'s matrices with their coefficients as integers."""
    out = []
    for indptr, cols, uniq, index in mats:
        values = np.array(ints_from_limbs(uniq) + [0], dtype=object)[:-1]
        out.append((indptr, cols.astype(np.int64), values[index]))
    return out


def _products(indptr, cols, coefs, z, r0, r1) -> np.ndarray:
    a, b = int(indptr[r0]), int(indptr[r1])
    out = np.zeros(r1 - r0, dtype=object)
    if b == a:
        return out
    prods = coefs[a:b] * z[cols[a:b]]
    starts = (indptr[r0:r1] - a).astype(np.int64)
    nonempty = indptr[r0 + 1:r1 + 1] > indptr[r0:r1]
    out[nonempty] = np.add.reduceat(prods, starts[nonempty])
    return out


def products(mats, u: int, x: Sequence[int], w: np.ndarray,
             p: int) -> List[np.ndarray]:
    """(A z, B z, C z) mod p with z = (u | x | W), a block of rows at a
    time."""
    z = np.concatenate([np.array([u % p] + [v % p for v in x] + [0],
                                 dtype=object)[:-1], w])
    m = len(mats[0][0]) - 1
    out = []
    for mat in mats:
        parts = [_products(*mat, z, r0, min(m, r0 + BLOCK_ROWS)) % p
                 for r0 in range(0, m, BLOCK_ROWS)]
        out.append(np.concatenate(parts) if parts
                   else np.zeros(0, dtype=object))
    return out


def rows_off(prods, u: int, e: np.ndarray, p: int) -> int:
    """How many rows break (A z) o (B z) = u (C z) + E."""
    az, bz, cz = prods
    ee = np.zeros(len(az), dtype=object)
    ee[:min(len(e), len(az))] = e[:len(az)]
    bad = int(np.count_nonzero((az * bz - u * cz - ee) % p != 0))
    return bad + abs(len(e) - len(az))
