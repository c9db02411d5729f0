"""Public-parameter disk cache: commitment-key generators.

The part of the JAX package's ``proof/params_cache.py`` that the
commitment layer needs (``cache_dir``, ``_gens_to_bytes``,
``_gens_from_bytes``, ``load_generators``, ``_atomic_write``). The
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
from ..ops import field as F


def cache_dir() -> Path:
    base = os.environ.get("LURK_TPU_CACHE",
                          os.path.join(os.path.expanduser("~"),
                                       ".lurk_tpu"))
    d = Path(base) / "torch_public_params"
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
