"""HyperKZG's powers-of-tau SRS over BN254 (the SRS part only).

The part of the JAX package's ``proof/hyperkzg.py`` that the commitment
layer needs: ``_tau``, ``Srs``, ``load_srs`` and ``_load_srs_disk``.
The BN254 G1 commitment key is the SRS (``proof/nova.py``); the opening
protocol comes with the compression slice.

SRS: tau is derived from shake256 and used transiently to compute
[tau^i]_1 / [tau]_2, then discarded — a DEV SRS, functionally faithful
but not a trusted-setup ceremony. The powers come from the host C++
(``csrc/host/srs.cpp``); three points of every new batch are checked
against the Python fixed-base oracle, and a mismatch raises. Cached on
disk in the params-cache layout (``proof/params_cache.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List

import numpy as np

from ..curves import pairing as pr
from ..curves.weierstrass import BN254_G1, Affine
from ..hostlib import points_from_limbs

CURVE = BN254_G1
_TAU_LABEL = b"lurk_tpu.hyperkzg.tau.v1"


def _tau() -> int:
    """The dev-SRS toxic waste (see module docstring)."""
    d = hashlib.shake_256(_TAU_LABEL).digest(48)
    return int.from_bytes(d, "little") % CURVE.order


@dataclasses.dataclass
class Srs:
    powers: List[Affine]            # [tau^i]_1, i < n
    g2: pr.G2Point                  # [1]_2
    tau_g2: pr.G2Point              # [tau]_2


def _fixed_base_mul_table(gen: Affine, c: int = 8):
    """Window table for fast fixed-base scalar muls."""
    curve = CURVE
    n_win = (curve.scalar.num_bits + c - 1) // c
    table = []
    base = curve.jac_from_affine(gen)
    for _ in range(n_win):
        row = [(0, 1, 0)]
        acc = (0, 1, 0)
        for _ in range((1 << c) - 1):
            acc = curve.jac_add(acc, base)
            row.append(acc)
        table.append(row)
        for _ in range(c):
            base = curve.jac_double(base)
    return table, c


def _fixed_base_mul(table, c: int, k: int) -> Affine:
    curve = CURVE
    acc = (0, 1, 0)
    w = 0
    mask = (1 << c) - 1
    while k:
        d = k & mask
        if d:
            acc = curve.jac_add(acc, table[w][d])
        k >>= c
        w += 1
    return curve.jac_to_affine(acc)


_SRS_MEM: dict = {}


def load_srs(n: int) -> Srs:
    """Powers-of-tau SRS, grown and cached on disk (and in memory)."""
    for have, srs in _SRS_MEM.items():
        if have >= n:
            return srs
    srs = _load_srs_disk(n)
    _SRS_MEM.clear()
    _SRS_MEM[len(srs.powers)] = srs
    return srs


def _load_srs_disk(n: int) -> Srs:
    import fcntl
    from .params_cache import _atomic_write, cache_dir
    from ..hostlib.srs import srs_limbs
    key = "hyperkzg_srs_bn254"
    path = cache_dir() / f"{key}.bin"
    meta_path = cache_dir() / f"{key}.json"
    lock_path = cache_dir() / f"{key}.lock"
    tau = _tau()
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        limbs = np.zeros((0, 8), dtype="<u8")
        if path.exists() and meta_path.exists():
            have = min(json.loads(meta_path.read_text())["n"], n)
            limbs = np.frombuffer(path.read_bytes(), dtype="<u8",
                                  count=8 * have).reshape(have, 8)
        if len(limbs) < n:
            start = len(limbs)
            got = srs_limbs(CURVE, tau, start, n - start)
            # spot-check the host C++ batch against the Python
            # fixed-base oracle before trusting it
            table, c = _fixed_base_mul_table(CURVE.generator)
            for probe in sorted({0, len(got) // 2, len(got) - 1}):
                expect = _fixed_base_mul(
                    table, c, pow(tau, start + probe, CURVE.order))
                if points_from_limbs(got[probe:probe + 1])[0] != expect:
                    raise RuntimeError(
                        f"host SRS power {start + probe} differs from "
                        f"the Python fixed-base oracle")
            limbs = np.concatenate([limbs, got])
            _atomic_write(path, limbs.astype("<u8").tobytes())
            _atomic_write(meta_path, json.dumps({"n": n}).encode())
    return Srs(points_from_limbs(limbs), pr.G2_GEN,
               pr.g2_mul(tau, pr.G2_GEN))
