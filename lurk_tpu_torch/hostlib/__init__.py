"""ctypes wrappers for the port's host C++ (``csrc/host/``), built with
g++ by :func:`lurk_tpu_torch.native.load_host`.

Copies of the JAX package's ``native/{pedersen,srs,poseidon,r1cs,msm,
fastpack}.py`` (:mod:`.poseidon` is the witness-only Poseidon trace,
:mod:`.r1cs` the fold's sparse R1CS, :mod:`.msm` a CPU key's Pippenger,
:mod:`.fastpack` int packing through the CPython API). Points come
back as ``uint64[n, 8]`` (x then y, 4 little-endian 64-bit limbs each,
canonical); :func:`points_from_limbs` turns them into affine tuples with
numpy, not a loop over the points.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops import field as F

_R = 1 << 256


def to_limbs(v: int) -> np.ndarray:
    return np.asarray([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                       for i in range(4)], dtype=np.uint64)


def points_from_limbs(out: np.ndarray) -> List[Tuple[int, int]]:
    """``uint64[n, 8]`` -> [(x, y)]."""
    words = np.ascontiguousarray(out, dtype="<u8").view("<u4")
    coords = F.words_to_ints(words.reshape(-1, 2, 8))
    return list(zip(coords[:, 0].tolist(), coords[:, 1].tolist()))


def r2(modulus: int) -> np.ndarray:
    return to_limbs((_R * _R) % modulus)
