"""Data parallelism of the prover over several devices in one process.

Counterpart of the JAX package's ``parallel/sharding.py:99-322``, over
lists of torch devices instead of a ``jax.sharding.Mesh``, with no
collectives: each device hashes or commits its contiguous shard, and the
partial results meet on the host.

- :func:`prover_devices` says which devices the prover shards over
  (``LURK_TPU_MESH`` read as the JAX package reads it), cached;
- :func:`shard_hash_batch` / :func:`shard_hash_batch_ints` run the
  dense-schedule Poseidon (kernel K2 on CUDA) on each shard, the store's
  hydration waves while devices are set;
- :class:`ShardedMsmTable` / :func:`shard_msm` run the MSM (kernel K6)
  on each shard and sum the partial points on the host.

The JAX package's XLA:CPU workarounds (compile-cache guards, one MSM
executable per process, 64-point CPU chunks) have no counterpart: the
shapes are the same on every device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from ..curves.weierstrass import Affine, Curve
from ..fields import FieldSpec
from ..msm.kernel import MsmTable, to_affine
from ..ops import field as F
from ..poseidon.kernel import poseidon_hash_dense, preimages_to_tensor

_UNSET = "unset"
_PROVER_DEVICES: object = _UNSET


def prover_devices() -> Optional[List[torch.device]]:
    """The devices the prover shards over (hydration waves, commits): the
    CUDA devices when more than one is attached; with ``LURK_TPU_MESH``
    set, ``0`` turns sharding off and ``n`` > 1 takes the first n devices
    (any other value all of them). None means one device, no sharding.
    Cached after the first call (tests and ``chip_smoke.py`` set the
    cache, ``_PROVER_DEVICES``, to a list of their own)."""
    global _PROVER_DEVICES
    if _PROVER_DEVICES is not _UNSET:
        return _PROVER_DEVICES
    flag = os.environ.get("LURK_TPU_MESH", "")
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    chosen: Optional[List[torch.device]] = None
    if flag == "0":
        chosen = None
    elif flag:
        n = int(flag) if flag.isdigit() and int(flag) > 1 else len(devs)
        n = min(n, len(devs))
        chosen = devs[:n] if n > 1 else None
    elif len(devs) > 1:
        chosen = devs
    _PROVER_DEVICES = chosen
    return chosen


def _per_shard(n: int, n_dev: int) -> int:
    """The shard size: 64, doubled until the shards hold ``n``
    (sharding.py:188-194)."""
    per = 64
    while per * n_dev < n:
        per *= 2
    return per


# ---------------------------------------------------------------------------
# sharded Poseidon hydration
# ---------------------------------------------------------------------------


def shard_hash_batch(devices: Sequence[torch.device], field: FieldSpec,
                     arity: int, x: torch.Tensor) -> torch.Tensor:
    """Digests ``int32[16, B]`` of ``x: int32[arity, 16, B]``, B a
    multiple of ``len(devices)``: shard k of the batch axis is hashed on
    ``devices[k]`` by the dense schedule; the digests come back to
    ``x``'s device."""
    n_dev = len(devices)
    b = x.shape[-1]
    if b % n_dev:
        raise ValueError(f"batch {b} is not a multiple of {n_dev} devices")
    per = b // n_dev
    outs = [poseidon_hash_dense(
        field, arity, x[..., k * per:(k + 1) * per].to(dev).contiguous())
        for k, dev in enumerate(devices)]
    return torch.cat([o.to(x.device) for o in outs], dim=-1)


def shard_hash_batch_ints(devices: Sequence[torch.device],
                          field: FieldSpec, arity: int,
                          preimages_ints) -> list:
    """Host API for sharded hydration (ints in, digests out): pads the
    batch with zero preimages to ``per * len(devices)``, packs it to
    16-bit limbs, runs :func:`shard_hash_batch` and unpacks. The store's
    ``hydrate_z_cache`` routes its waves here while
    :func:`prover_devices` is set."""
    n = len(preimages_ints)
    size = _per_shard(n, len(devices)) * len(devices)
    padded = list(preimages_ints) + [[0] * arity] * (size - n)
    x = preimages_to_tensor(field, arity, padded, "cpu")
    out = shard_hash_batch(devices, field, arity, x)
    return F.limbs_to_ints(out[:, :n].numpy().T)


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------


class ShardedMsmTable:
    """Resident base shards for a long-lived base set: shard k (``per``
    bases, padded with rows the MSM skips) lives on ``devices[k]`` and
    runs the whole MSM on its slice; the partial points are summed on
    the host (n_dev - 1 additions)."""

    def __init__(self, devices: Sequence[torch.device], curve: Curve,
                 points: Sequence[Affine]):
        self.devices = list(devices)
        self.curve = curve
        self.n = len(points)
        self.per = _per_shard(self.n, len(self.devices))
        self.shards = [
            MsmTable.build(curve, points[k * self.per:(k + 1) * self.per],
                           dev)
            for k, dev in enumerate(self.devices)]

    def msm(self, scalars: Sequence[int]) -> Affine:
        if len(scalars) > self.n:
            raise ValueError(f"{len(scalars)} scalars for {self.n} bases")
        per = self.per
        outs = [tab.msm_async(scalars[k * per:(k + 1) * per])
                for k, tab in enumerate(self.shards)
                if len(scalars) > k * per]
        acc: Affine = None
        for out in outs:
            acc = self.curve.add(acc, to_affine(self.curve, out))
        return acc


def shard_msm(devices: Sequence[torch.device], curve: Curve,
              scalars: Sequence[int], points: Sequence[Affine]) -> Affine:
    """One-shot sharded MSM (table built per call; prefer
    :class:`ShardedMsmTable` for long-lived bases)."""
    n = len(scalars)
    return ShardedMsmTable(devices, curve, list(points)[:n]).msm(
        list(scalars))

