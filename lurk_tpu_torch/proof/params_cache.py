"""Public-parameter disk cache: commitment-key generators and R1CS
shapes.

The parts of the JAX package's ``proof/params_cache.py`` that the
commitment layer and the fold need (``cache_dir``, ``_gens_to_bytes``,
``_gens_from_bytes``, ``load_generators``, ``_atomic_write``; the shape
cache ``shape_cache_key``, ``save_shape``, ``load_shape``,
``_LazyRows``, ``cached_shape``, whose CSR arrays let the host R1CS skip
the LC-dict rows of a cached shape). The
on-disk layout is the JAX package's: 32-byte little-endian x and then y
per point, with a JSON sidecar. The directory is the port's own,
``torch_public_params`` under the same ``LURK_TPU_CACHE`` base
(default ``~/.lurk_tpu``), so the port never writes the JAX package's
files. Conversions go through numpy, not a loop over the points.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List

import numpy as np

from ..curves.weierstrass import Affine, Curve
from ..hostlib import points_from_limbs
from ..hostlib.fastpack import unpack_ints
from ..ops import field as F


def cache_base() -> Path:
    """``$LURK_TPU_CACHE``, default ``~/.lurk_tpu``: the base of the
    parameter cache, the CLI's proofs and commitments and its history."""
    return Path(os.environ.get("LURK_TPU_CACHE",
                               os.path.join(os.path.expanduser("~"),
                                            ".lurk_tpu")))


def cache_dir() -> Path:
    d = cache_base() / "torch_public_params"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _gens_to_bytes(gens: List[Affine]) -> bytes:
    """Affine points -> 64 bytes each (x, y little-endian)."""
    if any(pt is None for pt in gens):
        raise ValueError("the point at infinity has no byte encoding")
    return F.ints_to_words(gens).tobytes()


def _gens_from_bytes(data: bytes, n: int) -> List[Affine]:
    limbs = np.frombuffer(data, dtype="<u8", count=8 * n).reshape(n, 8)
    return points_from_limbs(limbs)


def load_generators(curve: Curve, label: bytes, n: int) -> List[Affine]:
    """Cached generator derivation; extends the cache file on growth.

    The read-modify-write of the shared cache entry is guarded by an
    fcntl file lock, and both files are written via temp + os.replace so
    a concurrent reader never sees a .bin/.json pair mid-update."""
    import fcntl
    key = f"ck_{curve.name}_{label.hex()}"
    path = cache_dir() / f"{key}.bin"
    meta_path = cache_dir() / f"{key}.json"
    lock_path = cache_dir() / f"{key}.lock"
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        data = b""
        if path.exists() and meta_path.exists():
            have = json.loads(meta_path.read_text())["n"]
            data = path.read_bytes()[:64 * min(have, n)]
            if have >= n:
                return _gens_from_bytes(data, n)
        have = len(data) // 64
        fresh = curve.derive_generators_from(label, have, n)
        data += _gens_to_bytes(fresh)
        _atomic_write(path, data)
        _atomic_write(meta_path, json.dumps(
            {"curve": curve.name, "label": label.hex(), "n": n}).encode())
        return _gens_from_bytes(data, n)


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# R1CS shape disk cache (abomonation-analog reload): skips the full
# first-step circuit synthesis on repeat proves.
# ---------------------------------------------------------------------------


def _shape_path(key: str) -> Path:
    return cache_dir() / f"shape-{key}.npz"


def shape_cache_key(field_name: str, rc: int, func) -> str:
    """Content-derived key: the LEM step function's frozen-IR repr is
    deterministic, so (field, rc, IR) pins the circuit."""
    import hashlib
    h = hashlib.sha256()
    h.update(field_name.encode())
    h.update(str(rc).encode())
    h.update(repr(func).encode())
    return h.hexdigest()[:32]


def lang_key(lang) -> tuple:
    """The coprocessors' symbols, sorted: a ``Lang``'s part of the cycle
    public parameters' cache keys (empty for no ``Lang``)."""
    if lang is None or not len(lang):
        return ()
    return tuple(sorted(str(s) for s, _ in lang.cproc_specs()))


def lang_circuits(lang) -> tuple:
    """A ``Lang``'s coprocessors as the in-memory caches of public
    parameters key them: each symbol and arity with its circuit's class
    and attributes (None for a coprocessor with no circuit). Step
    functions capture the circuits, so two ``Lang`` objects share
    parameters in memory only when their circuits are alike."""
    if lang is None:
        return ()
    return tuple(
        (str(sym), c.arity, None if c.circuit is None else (
            type(c.circuit).__module__, type(c.circuit).__qualname__,
            repr(sorted(vars(c.circuit).items()))))
        for sym, c in lang.coprocessors())


def save_shape(key: str, shape) -> None:
    """The shape's CSR arrays (:meth:`..proof.nova.R1CSShape.csr`),
    counts and digest, as the JAX package lays them out."""
    import io
    import zipfile
    arrays = {}
    for name, (indptr, idx, coef) in zip("abc", shape.csr()):
        arrays[f"{name}_indptr"] = indptr.astype(np.int64)
        arrays[f"{name}_idx"] = idx.astype(np.int64)
        arrays[f"{name}_coef"] = coef.view(np.uint8)
    arrays["meta"] = np.asarray(
        [shape.num_inputs, shape.num_aux, shape.num_constraints],
        dtype=np.int64)
    arrays["digest"] = np.frombuffer(shape.digest.encode(), dtype=np.uint8)
    # np.savez_compressed's layout, deflated at level 1: about twice as
    # fast as its default level, for about a tenth more space
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    _atomic_write(_shape_path(key), buf.getvalue())


def load_shape(key: str, field):
    """The cached R1CSShape, or None. Its rows are materialized only on
    access (:class:`_LazyRows`); the host R1CS takes its CSR arrays."""
    from .nova import R1CSShape
    path = _shape_path(key)
    if not path.exists():
        return None
    try:
        z = np.load(path)
    except OSError:
        return None
    num_inputs, num_aux, m = (int(v) for v in z["meta"])
    csr = [(z[f"{name}_indptr"].astype(np.uint64),
            z[f"{name}_idx"].astype(np.uint64),
            z[f"{name}_coef"].view(np.uint64)) for name in "abc"]
    shape = R1CSShape.__new__(R1CSShape)
    shape.p = field.modulus
    shape.field = field
    shape.num_inputs = num_inputs
    shape.num_aux = num_aux
    shape.rows = _LazyRows(csr, m)
    shape.digest = z["digest"].tobytes().decode()
    shape._csr = csr
    return shape


class _LazyRows:
    """List-like view over cached CSR arrays that materializes the
    Python LC-dict rows only on real access (len() stays cheap)."""

    def __init__(self, csr, m: int):
        self._csr = csr
        self._m = m
        self._rows = None

    def _mat(self):
        if self._rows is None:
            rows = [({}, {}, {}) for _ in range(self._m)]
            for which in range(3):
                indptr, idx, coef = self._csr[which]
                coefs = unpack_ints(coef, len(idx))
                idx_l = idx.tolist()
                ip = indptr.tolist()
                for r in range(self._m):
                    lc = rows[r][which]
                    for j in range(ip[r], ip[r + 1]):
                        lc[idx_l[j]] = coefs[j]
            self._rows = rows
        return self._rows

    def __len__(self) -> int:
        return self._m

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]


def cached_shape(key, field, synth_fn):
    """Load an R1CSShape from the disk cache or synthesize and save it.
    The cycle backends' augmented shapes cost minutes of Python LC
    algebra to synthesize; the cache turns that into an npz load."""
    shape = load_shape(key, field)
    if shape is not None:
        return shape
    shape = synth_fn()
    try:
        save_shape(key, shape)
    except OSError:
        pass
    return shape
