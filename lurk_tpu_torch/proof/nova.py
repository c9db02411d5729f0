"""Pedersen commitment keys (the commitment part of Nova's NIFS).

The ``CommitmentKey`` of the JAX package's ``proof/nova.py`` (:67-256),
with one route per device and no fallback:

- a commit of ``_DEVICE_COMMIT_THRESHOLD`` or more scalars goes to the
  key's :class:`..msm.kernel.MsmTable`: on a CUDA key the MSM kernel
  (K6), on a CPU key its plain version; while :func:`prover_devices`
  names several devices, to a :class:`ShardedMsmTable` over them;
- a smaller commit goes to the host ``Curve.pippenger``.

Left out of the JAX class: the TPU-era device/host race, its disk-cached
route and ``LURK_TPU_DEVICE_COMMITS``. Shapes, witnesses and the fold
come with the folding slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..curves.weierstrass import Affine, Curve
from ..device import resolve_device
from ..msm.kernel import MsmTable, to_affine
from ..parallel import sharding

# Commits of at least this many scalars go to the table (nova.py:211,
# 249 use 64 for the native and mesh routes).
_DEVICE_COMMIT_THRESHOLD = 64


class CommitmentKey:
    """Generator basis for Pedersen vector commitments, with its MSM
    table resident on ``device`` (default ``cuda``)."""

    def __init__(self, curve: Curve, gens: List[Affine], device=None):
        self.curve = curve
        self.gens = gens
        self.device = resolve_device(device)
        self._table: Optional[MsmTable] = None
        self._sharded = None

    @staticmethod
    def setup(curve: Curve, label: bytes, n: int,
              device=None) -> "CommitmentKey":
        """BN254 G1 uses the HyperKZG powers-of-tau SRS as its basis (the
        reference's Bn256EngineKZG commits with the KZG engine,
        nova.rs:56-71); other curves use hash-derived generators. The
        prover's labels are ``b"lurk_tpu.ck." + curve.name`` and its
        sizes powers of two (``proof/supernova_cycle.py:138-147``)."""
        if curve.name == "bn254-g1":
            from .hyperkzg import load_srs
            return CommitmentKey(curve, load_srs(n).powers, device)
        from .params_cache import load_generators
        return CommitmentKey(curve, load_generators(curve, label, n), device)

    def table(self) -> MsmTable:
        """The key's MSM table on its device, built at first use."""
        if self._table is None:
            self._table = MsmTable.build(self.curve, self.gens, self.device)
        return self._table

    def sharded_table(self, devices) -> "sharding.ShardedMsmTable":
        """The key's table sharded over ``devices``, built at first use."""
        if self._sharded is None or self._sharded.devices != list(devices):
            self._sharded = sharding.ShardedMsmTable(devices, self.curve,
                                                     self.gens)
        return self._sharded

    def _check(self, vec: Sequence[int]) -> int:
        n = len(vec)
        if n > len(self.gens):
            raise ValueError(f"commitment key too small: {n} scalars, "
                             f"{len(self.gens)} generators")
        return n

    def commit(self, vec: Sequence[int]) -> Affine:
        n = self._check(vec)
        if n < _DEVICE_COMMIT_THRESHOLD:
            return self.curve.pippenger(list(vec), self.gens[:n])
        devices = sharding.prover_devices()
        if devices is not None:
            return self.sharded_table(devices).msm(vec)
        return self.table().msm(vec)

    def commit_async(self, vec: Sequence[int]) -> Callable[[], Affine]:
        """Dispatch the commit without waiting for the card when it goes
        to the single table; returns a zero-argument resolver."""
        n = self._check(vec)
        if n >= _DEVICE_COMMIT_THRESHOLD and \
                sharding.prover_devices() is None:
            out = self.table().msm_async(vec)
            return lambda: to_affine(self.curve, out)
        pt = self.commit(vec)
        return lambda: pt
