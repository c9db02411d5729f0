"""Headline benchmark of the port: batched Poseidon-4 throughput on one
CUDA card, the counterpart of the JAX package's ``bench.py``.

Usage: python -m lurk_tpu_torch.bench [--schedule {sparse,dense,folded}]

Prints exactly one JSON line:
  {"metric": "poseidon4_hashes_per_s", "value": N, "unit": "hashes/s",
   "vs_baseline": N, "msm_2e20_ms": N, "msm_2e20_pipelined_ms": N}

Poseidon-4 over the Pallas scalar field at B = 2^17 (the JAX bench's
inputs: 16-bit limbs from numpy's generator seeded 42), one warm launch,
then 10 launches timed on the host clock with one synchronisation.
``vs_baseline`` is against BASELINE.json's north star of 1e7 Poseidon-4
hashes/s per chip. The JAX bench walks a ladder of TPU kernels and falls
through to the next when one fails; here ``--schedule`` names the kernel
(``sparse``: csrc/poseidon.cu, the ladder's first candidate; ``dense``:
csrc/poseidon_dense.cu; ``folded``: csrc/poseidon_folded.cu, the ladder's
``opt`` candidates) and nothing falls back. Lane 7's digest is checked
against the host ``hash_preimage``; a mismatch raises.

The MSM figures are the 2^20-point BN254 G1 commitment through
csrc/msm.cu (1,024 bases repeated), from Python scalars to the projective
result on the card: the best of two single runs, and the mean of four
issued back to back (the prover's commit pattern), after a spot check of
64 scalars against the host Pippenger.

Without a CUDA card it raises: there is no CPU counterpart.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from .curves.weierstrass import BN254_G1
from .device import resolve_device
from .fields import PALLAS_SCALAR
from .msm.kernel import MsmTable
from .ops import field as F
from .poseidon import kernel as K
from .poseidon.host import hash_preimage

ARITY = 4
BATCH = 1 << 17
TIMED = 10
BASELINE = 1e7                 # BASELINE.json: Poseidon-4 hashes/s/chip
MSM_N = 1 << 20
MSM_BASES = 1024
CHECK_LANE = 7
SCHEDULES = {"sparse": K.poseidon_hash, "dense": K.poseidon_hash_dense,
             "folded": K.poseidon_hash_folded}


def poseidon_bench(schedule: str, device: torch.device) -> dict:
    """The Poseidon-4 figures of the line; raises if lane 7 is wrong."""
    hasher = SCHEDULES[schedule]
    rng = np.random.default_rng(42)
    arr = rng.integers(0, 1 << 16, size=(ARITY, F.N_LIMBS, BATCH),
                       dtype=np.uint32)
    x = torch.from_numpy(arr.astype(np.int32)).to(device)
    out = hasher(PALLAS_SCALAR, ARITY, x)
    pre = F.limbs_to_ints(arr[:, :, CHECK_LANE])
    got = F.limbs_to_ints(out[:, CHECK_LANE:CHECK_LANE + 1].cpu().numpy().T)
    if got != [hash_preimage(PALLAS_SCALAR, pre)]:
        raise RuntimeError(f"{schedule} kernel: lane {CHECK_LANE}'s digest "
                           f"differs from the host hash_preimage")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        hasher(PALLAS_SCALAR, ARITY, x)
    torch.cuda.synchronize(device)
    rate = BATCH * TIMED / (time.perf_counter() - t0)
    return {"metric": "poseidon4_hashes_per_s", "value": round(rate, 1),
            "unit": "hashes/s", "vs_baseline": round(rate / BASELINE, 4)}


def msm_bench(device: torch.device) -> dict:
    """``msm_2e20_ms`` and ``msm_2e20_pipelined_ms``; raises if the spot
    check fails."""
    curve = BN254_G1
    r = random.Random(11)
    pts, acc = [], curve.generator
    for _ in range(MSM_BASES):
        acc = curve.add(acc, curve.generator)
        pts.append(acc)
    bases = pts * (MSM_N // MSM_BASES)
    tab = MsmTable.build(curve, bases, device)
    small = [r.randrange(curve.order) for _ in range(64)]
    if tab.msm(small) != curve.pippenger(small, bases[:64]):
        raise RuntimeError("MSM spot check differs from the host Pippenger")

    def scalars():
        return [r.randrange(curve.order) for _ in range(MSM_N)]

    tab.msm_async(scalars())                # warm
    torch.cuda.synchronize(device)
    single = []
    for _ in range(2):
        sc = scalars()
        t0 = time.perf_counter()
        tab.msm_async(sc)
        torch.cuda.synchronize(device)
        single.append(time.perf_counter() - t0)
    scs = [scalars() for _ in range(4)]
    t0 = time.perf_counter()
    for sc in scs:
        tab.msm_async(sc)
    torch.cuda.synchronize(device)
    pipelined = (time.perf_counter() - t0) / len(scs)
    return {"msm_2e20_ms": round(min(single) * 1e3, 1),
            "msm_2e20_pipelined_ms": round(pipelined * 1e3, 1)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=sorted(SCHEDULES),
                    default="sparse")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    line = poseidon_bench(args.schedule, device)
    line.update(msm_bench(device))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
