"""Host-route timings of lurk_tpu_torch on the CPU: packing field
elements through ``hostlib.fastpack`` against ``ops.field.ints_to_words``,
and commits of n random BN254 scalars through the three CPU MSMs: the
host C++ Pippenger (``hostlib.msm``, a CPU commitment key's route and
every key's below 64 scalars), the Python ``Curve.pippenger`` (the JAX
package's route below 64 scalars) and, with ``--plain``, the MSM's plain
version (``msm.kernel.msm_plain``, what a CPU ``MsmTable`` runs); and
arity-4 Poseidon hashes one at a time, as the transcript makes them,
through the host C++ (``hostlib.poseidon.hash_batch``) and the Python
permutation (``poseidon.host.hash_preimage``, the JAX transcript's).
Every route's result is checked equal.

Usage: ``python scripts/torch_host_timings.py [--pack N] [--lanes N ...]
[--hashes N] [--plain]`` from the root of the repo (one torch thread;
prints one JSON line of host-clock seconds).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lurk_tpu_torch.curves.weierstrass import BN254_G1  # noqa: E402
from lurk_tpu_torch.hostlib import fastpack  # noqa: E402
from lurk_tpu_torch.hostlib import msm as host_msm  # noqa: E402
from lurk_tpu_torch.hostlib.poseidon import hash_batch  # noqa: E402
from lurk_tpu_torch.poseidon.host import hash_preimage  # noqa: E402
from lurk_tpu_torch.hostlib.r1cs import PackedVec  # noqa: E402
from lurk_tpu_torch.msm import kernel as M  # noqa: E402
from lurk_tpu_torch.ops import field as F  # noqa: E402


def _seconds(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _commits(curve, vals, n: int, plain: bool) -> dict:
    pts = curve.derive_generators_from(b"lurk_tpu_torch.timings", 0, n)
    scal = PackedVec.pack(vals[:n], curve.order)
    host, t_host = _seconds(lambda: host_msm.msm(
        curve, scal.arr, host_msm.pack_points(pts)))
    py, t_py = _seconds(lambda: curve.pippenger(vals[:n], pts))
    if host != py:
        raise RuntimeError("host C++ and Python Pippenger disagree")
    out = {"lanes": n, "host_msm_s": t_host, "curve_pippenger_s": t_py}
    if plain:
        table = M.MsmTable.build(curve, pts, "cpu")
        w = torch.from_numpy(scal.arr.view(np.int32).reshape(n, 8))
        got, out["plain_msm_s"] = _seconds(lambda: M.to_affine(
            curve, M.msm_words(table.prefix(n), w)))
        if got != host:
            raise RuntimeError("host Pippenger and plain MSM disagree")
    return out


def _hashes(field, vals, n: int) -> dict:
    pres = [vals[4 * i:4 * i + 4] for i in range(n)]
    hash_batch(field, 4, pres[:1])                # built before timing
    host, t_host = _seconds(lambda: [hash_batch(field, 4, [pre])[0]
                                     for pre in pres])
    py, t_py = _seconds(lambda: [hash_preimage(field, pre) for pre in pres])
    if host != py:
        raise RuntimeError("host C++ and Python Poseidon disagree")
    return {"hashes": n, "host_poseidon_s": t_host,
            "python_poseidon_s": t_py}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pack", type=int, default=10 ** 6,
                    help="field elements to pack")
    ap.add_argument("--lanes", type=int, nargs="+", default=[1024],
                    help="scalars of each commit")
    ap.add_argument("--hashes", type=int, default=100,
                    help="arity-4 Poseidon hashes, one call each")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain MSM too (minutes at 10^4 lanes)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    curve = BN254_G1
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "little") % curve.order
            for _ in range(max(args.pack, *args.lanes, 4 * args.hashes))]
    fastpack.pack_ints(vals[:1])                  # built before timing
    packed, t_fast = _seconds(lambda: fastpack.pack_ints(vals[:args.pack]))
    words, t_numpy = _seconds(lambda: F.ints_to_words(vals[:args.pack]))
    if packed.tobytes() != words.tobytes():
        raise RuntimeError("fastpack and ints_to_words disagree")
    host_msm.msm(curve, PackedVec.pack(vals[:1], curve.order).arr,
                 host_msm.pack_points([curve.generator]))  # built
    out = {"pack_n": args.pack, "fastpack_s": t_fast,
           "ints_to_words_s": t_numpy,
           "commits": [_commits(curve, vals, n, args.plain)
                       for n in args.lanes],
           "transcript": _hashes(curve.base, vals, args.hashes)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
