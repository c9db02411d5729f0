"""ctypes wrapper for the host Poseidon witness trace
(``csrc/host/poseidon.cpp``), a copy of the JAX package's
``native/poseidon.py``.

Oracle: :func:`lurk_tpu_torch.poseidon.circuit.witness_trace_and_digest`
(pure Python). The library is built with g++ at first use and raises
if it cannot be built; there is no Python fallback on the witness path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native
from ..poseidon.spec import poseidon_spec

_R = 1 << 256
_HANDLES: Dict[Tuple[str, int], Tuple[int, int]] = {}
_LOCK = threading.Lock()


def _limbs(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _lib() -> ctypes.CDLL:
    lib = native.load_host("poseidon")
    lib.lurk_poseidon_new.restype = ctypes.c_long
    lib.lurk_poseidon_trace.restype = None
    lib.lurk_poseidon_hash_many.restype = None
    return lib


def _handle(field, arity: int) -> Tuple[int, int]:
    """(handle, S-boxes per hash) of (field, arity), made once."""
    key = (field.name, arity)
    with _LOCK:
        h = _HANDLES.get(key)
        if h is not None:
            return h
        spec = poseidon_spec(field, arity)
        p = field.modulus
        mod = np.frombuffer(_limbs(p), dtype=np.uint64)
        r2 = np.frombuffer(_limbs((_R * _R) % p), dtype=np.uint64)
        rc = np.frombuffer(b"".join(_limbs(c % p)
                                    for c in spec.round_constants),
                           dtype=np.uint64)
        mds = np.frombuffer(b"".join(_limbs(spec.mds[i][j] % p)
                                     for i in range(spec.width)
                                     for j in range(spec.width)),
                            dtype=np.uint64)
        hd = _lib().lurk_poseidon_new(
            _u64p(mod), _u64p(r2), ctypes.c_int(spec.width),
            ctypes.c_int(spec.full_rounds),
            ctypes.c_int(spec.partial_rounds), _u64p(rc), _u64p(mds))
        n_sboxes = spec.width * spec.full_rounds + spec.partial_rounds
        h = _HANDLES[key] = (hd, n_sboxes)
        return h


def hash_batch(field, arity: int, pres: Sequence[Sequence[int]]
               ) -> List[int]:
    """Digests of ``pres`` (lists of ``arity`` ints) on the host."""
    hd, _ = _handle(field, arity)
    if any(len(pre) != arity for pre in pres):
        raise ValueError(f"expected preimages of length {arity}")
    p = field.modulus
    tag = _limbs(poseidon_spec(field, arity).domain_tag)
    buf = b"".join(
        tag + b"".join(_limbs(x % p) for x in pre) for pre in pres)
    states = np.frombuffer(buf, dtype=np.uint64)
    out = np.zeros(len(pres) * 4, dtype=np.uint64)
    _lib().lurk_poseidon_hash_many(ctypes.c_long(hd), _u64p(states),
                                   ctypes.c_uint64(len(pres)), _u64p(out))
    by = out.tobytes()
    return [int.from_bytes(by[32 * i:32 * (i + 1)], "little")
            for i in range(len(pres))]


def witness_trace_and_digest(field, preimage: Sequence[int]
                             ) -> Tuple[List[int], int]:
    """The aux trace (x2, x4, x5 per S-box, allocation order) and the
    digest of ``preimage``: the C++ counterpart of
    :func:`lurk_tpu_torch.poseidon.circuit.witness_trace_and_digest`."""
    arity = len(preimage)
    hd, n_sboxes = _handle(field, arity)
    p = field.modulus
    state0 = np.frombuffer(
        _limbs(poseidon_spec(field, arity).domain_tag)
        + b"".join(_limbs(x % p) for x in preimage), dtype=np.uint64)
    out_tr = np.zeros(n_sboxes * 3 * 4, dtype=np.uint64)
    out_dg = np.zeros(4, dtype=np.uint64)
    _lib().lurk_poseidon_trace(ctypes.c_long(hd), _u64p(state0),
                               _u64p(out_tr), _u64p(out_dg))
    by = out_tr.tobytes()
    trace = [int.from_bytes(by[32 * i:32 * (i + 1)], "little")
             for i in range(n_sboxes * 3)]
    return trace, int.from_bytes(out_dg.tobytes(), "little")
