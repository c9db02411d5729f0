"""ctypes wrapper for the host Spartan sumcheck kernels
(``csrc/host/spartan.cpp``) and the Spartan entries of
``csrc/host/r1cs.cpp``.

A copy of the JAX package's ``native/spartan.py``. It is the port's only
route for the compression's sumchecks, chi tables, MLE evaluations and
sparse matrix products, and for HyperKZG's fold chain (``bind_eo``,
``poly_eval``, ``poly_quotient``): there is no Python path, and a
failed build raises. The oracle is the JAX package's Python loops
(``proof/mle.py``, ``proof/spartan.py``, ``proof/hyperkzg.py``), held in
``tests/test_torch_compress.py``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import numpy as np

from .. import native
from . import r2, to_limbs
from .r1cs import PackedVec, _as_packed, _pack_vec, _threads, handle_for
from .fastpack import unpack_ints


def _lib() -> ctypes.CDLL:
    lib = native.load_host("spartan")
    v, u64, i = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.lurk_vec_to_mont.argtypes = [v, v, u64, v, v, i]
    lib.lurk_vec_from_mont.argtypes = [v, v, u64, v, v, i]
    lib.lurk_sc_round1.argtypes = [v, v, u64] + [v] * 7 + [i]
    lib.lurk_sc_round2.argtypes = [v, v, u64, v, v, v, i]
    lib.lurk_sc_bind.argtypes = [v, v, u64, v, v, i]
    lib.lurk_chi_table.argtypes = [v, v, u64, v, v, i]
    lib.lurk_bind_eo.argtypes = [v, v, u64, v, v, i]
    lib.lurk_poly_eval.argtypes = [v, v, u64, v, v, v]
    lib.lurk_poly_quotient.argtypes = [v, v, u64, v, v, v]
    for f in (lib.lurk_vec_to_mont, lib.lurk_vec_from_mont,
              lib.lurk_sc_round1, lib.lurk_sc_round2, lib.lurk_sc_bind,
              lib.lurk_chi_table, lib.lurk_bind_eo, lib.lurk_poly_eval,
              lib.lurk_poly_quotient):
        f.restype = None
    return lib


def _r1cs_lib() -> ctypes.CDLL:
    lib = native.load_host("r1cs")
    v, u64, ll = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_long
    lib.lurk_spartan_mvec.argtypes = [ll, v, v, u64, u64, v]
    lib.lurk_spartan_mvec.restype = None
    lib.lurk_spartan_matrix_evals.argtypes = [ll, v, v, u64, u64, v]
    lib.lurk_spartan_matrix_evals.restype = None
    return lib


def _mod_r2(p: int):
    return to_limbs(p), r2(p)


def _scalar(v: int, p: int) -> np.ndarray:
    return to_limbs(v % p)


def to_mont(vec, p: int) -> np.ndarray:
    mod, rsq = _mod_r2(p)
    arr = _as_packed(vec, p)
    out = np.empty_like(arr)
    _lib().lurk_vec_to_mont(mod.ctypes.data, rsq.ctypes.data,
                            arr.size // 4, arr.ctypes.data,
                            out.ctypes.data, _threads())
    return out


def from_mont(arr: np.ndarray, n: int, p: int) -> List[int]:
    mod, rsq = _mod_r2(p)
    out = np.empty(4 * n, dtype=np.uint64)
    _lib().lurk_vec_from_mont(mod.ctypes.data, rsq.ctypes.data, n,
                              arr.ctypes.data, out.ctypes.data, _threads())
    return unpack_ints(out, n)


def chi_table_pv(rs: Sequence[int], p: int) -> PackedVec:
    """chi[i] = prod_j (r_j if bit_j(i) else 1 - r_j), bit_0 the MSB."""
    mod, rsq = _mod_r2(p)
    k = len(rs)
    rs_arr = _pack_vec([v % p for v in rs], p)
    out = np.empty(4 << k, dtype=np.uint64)
    _lib().lurk_chi_table(mod.ctypes.data, rsq.ctypes.data, k,
                          rs_arr.ctypes.data, out.ctypes.data, _threads())
    return PackedVec(out, 1 << k, p)


def chi_table(rs: Sequence[int], p: int) -> List[int]:
    return chi_table_pv(rs, p).ints()


def _sumcheck(arrs: List[np.ndarray], n_evals: int, round_fn, p: int,
              challenge: Callable[[Sequence[int]], int]
              ) -> Tuple[List[List[int]], List[int], List[int]]:
    """The round loop both sumchecks share: one round's evaluations
    from ``round_fn(half, out)``, the challenge, then every array
    bound at it."""
    lib = _lib()
    mod, rsq = _mod_r2(p)
    rounds: List[List[int]] = []
    rs: List[int] = []
    half = arrs[0].size // 8
    evals = np.empty(4 * n_evals, dtype=np.uint64)
    while half >= 1:
        round_fn(half, evals)
        ev = unpack_ints(evals, n_evals)
        rounds.append(ev)
        r = challenge(ev)
        rs.append(r)
        r_arr = _scalar(r, p)
        for a in arrs:
            lib.lurk_sc_bind(mod.ctypes.data, rsq.ctypes.data, half,
                             a.ctypes.data, r_arr.ctypes.data, _threads())
        half //= 2
    return rounds, rs, [from_mont(a, 1, p)[0] for a in arrs]


def sumcheck1(eq, az, bz, cz, e, u: int, p: int,
              challenge: Callable[[Sequence[int]], int]
              ) -> Tuple[List[List[int]], List[int], List[int]]:
    """Degree-3 sumcheck over comb = eq * (az * bz - u * cz - e): the
    round polynomials (4 evaluations each), the challenges, and the
    final value of each array."""
    lib = _lib()
    mod, rsq = _mod_r2(p)
    arrs = [to_mont(v, p) for v in (eq, az, bz, cz, e)]
    u_arr = _scalar(u, p)

    def round_fn(half, out):
        lib.lurk_sc_round1(mod.ctypes.data, rsq.ctypes.data, half,
                           *(a.ctypes.data for a in arrs),
                           u_arr.ctypes.data, out.ctypes.data, _threads())
    return _sumcheck(arrs, 4, round_fn, p, challenge)


def sumcheck2(mv, z, p: int, challenge: Callable[[Sequence[int]], int]
              ) -> Tuple[List[List[int]], List[int], List[int]]:
    """Degree-2 sumcheck over comb = m * z."""
    lib = _lib()
    mod, rsq = _mod_r2(p)
    arrs = [to_mont(mv, p), to_mont(z, p)]

    def round_fn(half, out):
        lib.lurk_sc_round2(mod.ctypes.data, rsq.ctypes.data, half,
                           arrs[0].ctypes.data, arrs[1].ctypes.data,
                           out.ctypes.data, _threads())
    return _sumcheck(arrs, 3, round_fn, p, challenge)


def spartan_mvec(shape, chi_rx, r: int, n_half: int) -> PackedVec:
    """(A + r B + r^2 C)^T chi over the split-z domain of 2 n_half."""
    h = handle_for(shape)
    p = shape.p
    chi_arr = _as_packed(chi_rx, p)
    r_arr = _scalar(r, p)
    out = np.empty(8 * n_half, dtype=np.uint64)
    _r1cs_lib().lurk_spartan_mvec(h, chi_arr.ctypes.data, r_arr.ctypes.data,
                                  n_half, shape.num_inputs, out.ctypes.data)
    return PackedVec(out, 2 * n_half, p)


def matrix_evals(shape, chi_rx, chi_ry, n_half: int) -> Tuple[int, int, int]:
    """(A~, B~, C~)(rx, ry) over the split-z domain."""
    h = handle_for(shape)
    p = shape.p
    rx_arr, ry_arr = _as_packed(chi_rx, p), _as_packed(chi_ry, p)
    out = np.empty(12, dtype=np.uint64)
    _r1cs_lib().lurk_spartan_matrix_evals(
        h, rx_arr.ctypes.data, ry_arr.ctypes.data, n_half,
        shape.num_inputs, out.ctypes.data)
    a, b, c = unpack_ints(out, 3)
    return a, b, c


def mle_eval(vec, rs: Sequence[int], p: int) -> int:
    """The MLE of ``vec`` (length 2^len(rs)) at ``rs`` (bind_top
    chain)."""
    lib = _lib()
    mod, rsq = _mod_r2(p)
    arr = to_mont(vec, p)
    half = arr.size // 8
    for r in rs:
        r_arr = _scalar(r, p)
        lib.lurk_sc_bind(mod.ctypes.data, rsq.ctypes.data, half,
                         arr.ctypes.data, r_arr.ctypes.data, _threads())
        half //= 2
    return from_mont(arr, 1, p)[0]


def bind_eo(pv: PackedVec, x: int) -> PackedVec:
    """Gemini even/odd fold of a plain PackedVec, in place in ``pv``'s
    array; returns the halved vector as a copy."""
    mod, rsq = _mod_r2(pv.p)
    half = pv.n // 2
    x_arr = _scalar(x, pv.p)
    _lib().lurk_bind_eo(mod.ctypes.data, rsq.ctypes.data, half,
                        pv.arr.ctypes.data, x_arr.ctypes.data, _threads())
    return PackedVec(pv.arr[:4 * half].copy(), half, pv.p)


def poly_eval(pv: PackedVec, z: int) -> int:
    """Horner evaluation of the coefficient vector ``pv`` at ``z``."""
    mod, rsq = _mod_r2(pv.p)
    out = np.empty(4, dtype=np.uint64)
    z_arr = _scalar(z, pv.p)
    _lib().lurk_poly_eval(mod.ctypes.data, rsq.ctypes.data, pv.n,
                          pv.arr.ctypes.data, z_arr.ctypes.data,
                          out.ctypes.data)
    return unpack_ints(out, 1)[0]


def poly_quotient(pv: PackedVec, z: int) -> PackedVec:
    """(p(X) - p(z)) / (X - z) by synthetic division: n - 1
    coefficients."""
    mod, rsq = _mod_r2(pv.p)
    out = np.zeros(4 * (pv.n - 1), dtype=np.uint64)
    z_arr = _scalar(z, pv.p)
    _lib().lurk_poly_quotient(mod.ctypes.data, rsq.ctypes.data, pv.n,
                              pv.arr.ctypes.data, z_arr.ctypes.data,
                              out.ctypes.data)
    return PackedVec(out, pv.n - 1, pv.p)
