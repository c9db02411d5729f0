"""Host time of the port's IPA opening (``proof.ipa.prove``) over
Grumpkin, the secondary compression's critical path: n random scalars
a and b (numpy's generator seeded 1), n generators derived from a fixed
label, the opening timed ``--repeats`` times on the host clock and
checked by ``ipa.verify``. Each round's two MSMs go to the host
Pippenger (``hostlib.msm``, ``csrc/host/msm.cpp``), half of their
scalars 0.

Usage: ``python scripts/torch_ipa_timing.py [--n N] [--repeats R]``
from the root of the tree to time (run it from two trees in one call to
compare them); prints one JSON line of host-clock seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lurk_tpu_torch.curves.weierstrass import GRUMPKIN  # noqa: E402
from lurk_tpu_torch.hostlib import msm as host_msm  # noqa: E402
from lurk_tpu_torch.hostlib.fastpack import pack_ints  # noqa: E402
from lurk_tpu_torch.proof import ipa  # noqa: E402
from lurk_tpu_torch.proof.transcript import Transcript  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 15,
                    help="length of the opened vector (a power of two)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.setdefault("LURK_TPU_CACHE", tempfile.mkdtemp())
    curve, n = GRUMPKIN, args.n
    rng = np.random.default_rng(1)
    a, b = ([int.from_bytes(rng.bytes(32), "little") % curve.order
             for _ in range(n)] for _ in range(2))
    c = sum(x * y for x, y in zip(a, b)) % curve.order
    t0 = time.perf_counter()
    gens = curve.derive_generators_from(b"lurk_tpu_torch.ipa_timing", 0, n)
    comm = host_msm.msm(curve, pack_ints(a), host_msm.pack_points(gens))
    t_setup = time.perf_counter() - t0
    seconds = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        proof = ipa.prove(curve, gens, comm, a, b, c,
                          Transcript(curve, b"ipa-timing"))
        seconds.append(time.perf_counter() - t0)
    if not ipa.verify(curve, gens, comm, b, c, proof,
                      Transcript(curve, b"ipa-timing")):
        raise RuntimeError("the IPA opening did not verify")
    out = {"n": n, "cpus": os.cpu_count(), "setup_s": t_setup,
           "ipa_prove_s": seconds, "verified": True}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
