#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lurk_tpu_torch``) on one GPU.

Usage: python3 chip_smoke.py        (needs one CUDA card, nvcc and g++)

Phases, each fatal on failure:
  0. card: nvidia-smi name and power limit, versions; the three kernel
     sources built at once (one nvcc each), the host C++ with g++;
  1. K1 against plain: the sparse CUDA Poseidon against its plain
     PyTorch version on the card, 4 fields x arities 3/4/6/8 at B = 4096
     (random canonical preimages plus all-0 and all-(p-1) lanes), 8 lanes
     each against the host oracle, and the reference anchors through it;
  2. K1's main path: read fib(100) -> Store(BN256, cuda) -> LEM evaluate
     (800 frames) -> hydrate_z_cache, launch count = waves >= the
     threshold, every hydrated digest against host hashing on a second
     store; then K1 and its plain version at the main path's wave shapes;
  3. size: Poseidon-4 over Pallas at B = 2^17 and 2^20 and over BN256 at
     2^20, against the bound (integer multiply-add throughput);
  4. K6, the MSM: against its plain version and the host Pippenger at
     n = 2^12 on BN254 G1, Grumpkin, Pallas and Vesta (scalars 0, 1,
     order-1, and a table of 1024 bases repeated); then its main path:
     CommitmentKey.setup(BN254 G1, 2^21) (the HyperKZG SRS), a 2^20
     vector with 64 non-zero scalars against the host Pippenger, commits
     of random 2^20 and 2^21 vectors and a Grumpkin 2^16 key's commit
     (the 2^20 and the Grumpkin commits against the plain version on
     the card); the two-shard table over [cuda:0, cuda:0] against the
     single table; times and bounds;
  5. K2, the dense Poseidon: against its plain version and the host
     oracle (4 fields x 4 arities at B = 4096), the anchors through it,
     then its main path: fib(100) hydrated with the prover devices set to
     [cuda:0, cuda:0], two launches per batched wave, every digest
     against host hashing; Poseidon-4 at 2^17 and 2^20 against the bound;
  6. the folded Poseidon (csrc/poseidon_folded.cu): against its plain
     version and the host oracle (4 fields x 4 arities at B = 4096), the
     anchors through it, then its main path: the port's bench
     (lurk_tpu_torch/bench.py) Poseidon-4 run through it (11 launches at
     2^17); Poseidon-4 at 2^17 and 2^20 against the bound; then
     ``python -m lurk_tpu_torch.bench --schedule folded`` and
     ``--schedule sparse`` as subprocesses, each printing its one line;
  7. the step circuit: the blank frame's 11,057 constraints and 9,029
     aux, frame 0 of fib(100) fully synthesized with every constraint
     checked, witness-only equal to full synthesis on the first 5 frames
     at rc = 5; then the main path from phase 2's hydrated fib(100):
     MultiFrame.from_frames(rc=100) -> 8 witness-only step instances ->
     each step's W committed with phase 4's 2^21 BN254 key through K6.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card or without the rest of the repository.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20240601
PHASE1_BATCH = 4096
SIZES = [("pallas", 1 << 17), ("pallas", 1 << 20), ("bn256", 1 << 20)]
DENSE_SIZES = [("pallas", 1 << 17), ("pallas", 1 << 20)]
TIMED_LAUNCHES = 10
MSM_CHECK_N = 1 << 12
CK_BN254 = 1 << 21            # fib(100)'s primary key: max(aux, constraints)
COMMITS = (1 << 20, 1 << 21)  # W's size (about 100 x 9,029) and the key's
CK_GRUMPKIN = 1 << 16
REPEATED_BASES = 1024          # bench.py:180-184 repeats 1024 points
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
IMAD_PER_CLK_PER_SM = 64       # 32-bit integer multiply-add, cc 9.0
# 32-bit multiply-adds (IMAD) per operation on 8 x 32-bit limbs, a wide
# 32x32->64 product counting 2 (low and high word)
PRODUCT = 2 * 64               # a*b: 64 wide products
SQUARE = 2 * 36                # a*a: n(n+1)/2 = 36, cross terms doubled
REDC = 2 * 64 + 8              # Montgomery reduction: m*p, and m itself
MUL = PRODUCT + REDC           # one general field product, 264
# The cheapest known point additions, two products summed before one
# reduction where a coordinate is such a sum: an affine point into a
# bucket by XYZZ mixed addition (madd-2008-s: 8 products, 2 squarings,
# Y3 = R (Q - X3) - Y1 PPP reduced once), 2,392; two buckets by RCB15
# Alg. 7 (12 products, its 3b products by a small constant not counted,
# X3, Y3 and Z3 each reduced once), 2,760
MADD = 8 * PRODUCT + 2 * SQUARE + 9 * REDC
ADD = 12 * PRODUCT + 9 * REDC
PLAIN_CHUNK = 1 << 17          # lanes per plain MSM call at the main size
TRIE_ROOTS = [
    0x1ca5b207085f3f0f324a2e0704b18fff1cda2e2d686aa85343fea91df77bf35b,
    0x0637ddaef5cd53ba6711c328952208d846222066701e10c34d3a6df7350de8aa,
    0x08127a45502f5939273edd1957c8748ae39992e2a459d99f999992a842df99a5,
    0x12c2ef2ab5df25442fe23d8711bf985f02c39e83930517f7103d4bd4228c6cfb,
]
COMMIT_NUM0 = \
    0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201
COMMIT_ID_FUN = \
    0x2f31ee658b82c09daebbd2bd976c9d6669ad3bd6065056763797d5aaf4a3001b
SOURCES = ["poseidon", "poseidon_dense", "msm", "poseidon_folded"]
BENCH_TIMEOUT_S = 300
STEP_RC = 100                  # fib(100)'s 800 frames in 8 folding steps
CHECK_RC = 5


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str, extra: str = "") -> str:
    fmt = "csv,noheader" + extra
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", f"--format={fmt}"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_preimages(field, arity: int, b: int, gen: torch.Generator,
                     device) -> torch.Tensor:
    """int32[arity, 16, b] random canonical limbs (top limb kept below
    p's); lane 0 all zeros and lane 1 all p-1 when b > 1."""
    from lurk_tpu_torch.ops import field as F
    x = torch.randint(0, 1 << 16, (arity, 16, b), generator=gen,
                      device=device, dtype=torch.int32)
    top = field.modulus >> 240
    x[:, 15, :] = torch.randint(0, top, (arity, b), generator=gen,
                                device=device, dtype=torch.int32)
    if b > 1:
        x[:, :, 0] = 0
        pm1 = torch.tensor(F.int_to_limbs(field.modulus - 1),
                           dtype=torch.int32, device=device)
        x[:, :, 1] = pm1
    return x


def lane_ints(x: torch.Tensor, lanes) -> list:
    from lurk_tpu_torch.ops import field as F
    return F.limbs_to_ints(x[..., lanes].cpu().numpy().T)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` back-to-back calls (CUDA events, one
    synchronisation), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def imad_per_hash(field, arity: int, kernel_schedule: bool = False,
                  dense: bool = False, folded: bool = False) -> int:
    """IMAD per hash: by default the least the sparse schedule needs
    (squarings as squarings, each mix row summed before its one
    reduction); with ``dense`` the same count for the dense schedule
    (a full t x t MDS every round); with ``folded`` for the folded
    schedule (full rounds dense, partial round r one row of t + r terms,
    the rebuild t rows of t + rp); with ``kernel_schedule`` what
    csrc/poseidon.cu does (every field product a full CIOS)."""
    from lurk_tpu_torch.poseidon.spec import poseidon_spec
    spec = poseidon_spec(field, arity)
    t, rf, rp = spec.width, spec.full_rounds, spec.partial_rounds
    sboxes, dense_rows, sparse = rf * t + rp, rf * t, rp
    if kernel_schedule:       # 3 products per S-box, t per row, 2t-1
        products = arity + 1 + 3 * sboxes + t * dense_rows \
            + sparse * (2 * t - 1)
        return products * MUL
    def row(k):
        return k * PRODUCT + REDC
    convert = arity * row(1) + REDC         # inputs in, the digest out
    sbox = 2 * (SQUARE + REDC) + row(1)     # x^2, x^4, x^5
    if dense:
        return convert + sboxes * sbox + (rf + rp) * t * row(t)
    if folded:
        return (convert + sboxes * sbox + dense_rows * row(t)
                + sum(row(t + r) for r in range(rp)) + t * row(t + rp))
    return (convert + sboxes * sbox + dense_rows * row(t)
            + sparse * (row(t) + (t - 1) * row(1)))


class Bound:
    """Least time the card could take: the larger of bytes over the
    memory rate and integer multiply-adds over the card's IMAD rate."""

    def __init__(self, sms: int, clock_mhz: float):
        self.imad_per_s = sms * IMAD_PER_CLK_PER_SM * clock_mhz * 1e6
        self.sms, self.clock_mhz = sms, clock_mhz

    def _max(self, ops: float, nbytes: float):
        ops_ms = 1e3 * ops / self.imad_per_s
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        return max(ops_ms, bytes_ms), \
            ("operations" if ops_ms >= bytes_ms else "bytes")

    def of(self, field, arity: int, b: int, const_bytes: int):
        """The Poseidon digest (K1's and K2's function alike) at its
        least work, the sparse schedule's."""
        ops = b * imad_per_hash(field, arity)
        return self._max(ops, b * (arity + 1) * 16 * 4 + const_bytes)

    def msm(self, words: np.ndarray, table_rows: int):
        """The MSM of these reduced scalar words with the kernel's 16-bit
        signed windows: one mixed addition for each non-zero digit that
        is not the first of its bucket (this run's data), and 2 additions
        per bucket for the running sums; bytes: the table, the scalars
        and the result once. Returns (ms, bound_by, mixed additions)."""
        from lurk_tpu_torch.msm.kernel import (
            C_BITS, N_BUCKETS, N_WIN, digits_from_words)
        madds = 0
        for win in digits_from_words(words, C_BITS)[0]:
            sizes = np.bincount(win, minlength=N_BUCKETS + 1)[1:]
            madds += int(sizes.sum()) - int(np.count_nonzero(sizes))
        ops = madds * MADD + 2 * N_WIN * N_BUCKETS * ADD
        nbytes = table_rows * 64 + words.shape[0] * 32 + 96
        return (*self._max(ops, nbytes), madds)


def compare(field, arity, x, hash_fn, plain_fn):
    """Kernel against plain on the same input: (max |diff|, digests)."""
    got = hash_fn(field, arity, x)
    want = plain_fn(field, arity, x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    mism = int((got != want).any(dim=0).sum())
    check(mism == 0, f"{field.name}/{arity}: {mism} lanes differ from plain")
    return err, got


def poseidon_against_plain(fields, gen, dev, hash_fn, plain_fn, what):
    """Phases 1 and 5.1: 4 fields x 4 arities at PHASE1_BATCH, 8 lanes
    each against the host oracle; returns the max |diff|."""
    from lurk_tpu_torch.poseidon.host import hash_preimage
    max_err = 0
    for name, field in fields.items():
        for arity in (3, 4, 6, 8):
            x = random_preimages(field, arity, PHASE1_BATCH, gen, dev)
            err, out = compare(field, arity, x, hash_fn, plain_fn)
            max_err = max(max_err, err)
            b = PHASE1_BATCH
            lanes = [0, 1, 2, 3, b // 4, b // 2, b - 2, b - 1]
            pres = [lane_ints(x[a], lanes) for a in range(arity)]
            want = [hash_preimage(field, [pres[a][j] for a in range(arity)])
                    for j in range(len(lanes))]
            check(lane_ints(out, lanes) == want,
                  f"{what} {name}/{arity}: differs from the host oracle")
    return max_err


def random_words(rng, order: int, n: int) -> np.ndarray:
    """uint32[n, 8] random scalars below ``order`` (top bit of the order
    cleared); lanes 0, 1, 2 are 0, 1 and order - 1 when n > 2."""
    from lurk_tpu_torch.msm.kernel import pack_scalar_words
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    w = w.astype(np.uint32)
    w[:, 7] &= np.uint32((1 << (order.bit_length() - 1 - 224)) - 1)
    if n > 2:
        w[:3] = pack_scalar_words([0, 1, order - 1], order)
    return w


def scalar_ints(words: np.ndarray) -> list:
    from lurk_tpu_torch.ops.field import words_to_ints
    return words_to_ints(words).tolist()


def words_on(table, words: np.ndarray) -> torch.Tensor:
    """Scalar words padded to the table's rows, on its device."""
    w = np.zeros((table.n, 8), dtype=np.uint32)
    w[:words.shape[0]] = words
    return torch.from_numpy(w.view(np.int32)).to(table.device)


def point_err(a, b) -> int:
    """max |coordinate difference| of two affine points (0 if equal)."""
    if a is None or b is None:
        return 0 if a is b else 1
    return max(abs(a[0] - b[0]), abs(a[1] - b[1]))


def phase4(bound, dev, devices):
    """K6: checks, the commitment main path, the sharded table, times."""
    from lurk_tpu_torch.curves.weierstrass import (
        BN254_G1, GRUMPKIN, PALLAS, VESTA)
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.parallel import sharding
    from lurk_tpu_torch.proof.nova import CommitmentKey
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    max_err = 0

    def held(curve, table, words, points, what):
        """Kernel, plain version and host Pippenger on one input."""
        nonlocal max_err
        w = words_on(table, words)
        got = M.to_affine(curve, M.msm_words(table, w))
        plain = M.to_affine(curve, M.msm_plain(curve, table.rows, w))
        host = curve.pippenger(scalar_ints(words), points)
        max_err = max(max_err, point_err(got, plain))
        check(got == plain, f"{what}: kernel differs from plain")
        check(got == host, f"{what}: kernel differs from the host Pippenger")

    # 4.1 against the plain version and the host at 2^12
    checked = {}
    for curve in (BN254_G1, GRUMPKIN, PALLAS, VESTA):
        pts = curve.derive_generators_from(
            b"chip_smoke." + curve.name.encode(), 0, MSM_CHECK_N)
        tab = M.MsmTable.build(curve, pts, dev)
        words = random_words(rng, curve.order, MSM_CHECK_N)
        held(curve, tab, words, pts, f"{curve.name} n=2^12")
        checked[curve.name] = (tab, words)
    base = checked["bn254-g1"][0]
    pts = BN254_G1.derive_generators_from(b"chip_smoke.repeat", 0,
                                          REPEATED_BASES) * 4
    held(BN254_G1, M.MsmTable.build(BN254_G1, pts, dev),
         random_words(rng, BN254_G1.order, len(pts)), pts,
         "1024 bases repeated 4 times")
    w12 = words_on(base, checked["bn254-g1"][1])
    k12 = time_ms(lambda: M.msm_words(base, w12), TIMED_LAUNCHES)
    p12 = time_ms(lambda: M.msm_plain(BN254_G1, base.rows, w12), 1)
    b12, by12, _ = bound.msm(checked["bn254-g1"][1], base.n)
    print(f"phase 4.1: 4 curves at n=2^12 and 1024 bases x 4: kernel = "
          f"plain = host Pippenger; BN254 n=2^12: kernel {k12:.3f} ms, "
          f"plain {p12:.1f} ms, bound {b12:.4f} ms ({by12}) "
          f"({time.perf_counter() - t0:.1f} s)")

    # 4.2 the key, and a 2^20 vector with 64 non-zero scalars
    t0 = time.perf_counter()
    key = CommitmentKey.setup(BN254_G1, b"lurk_tpu.ck.bn254-g1", CK_BN254,
                              dev)
    t_setup = time.perf_counter() - t0
    print(f"phase 4.2: CommitmentKey.setup(BN254 G1, 2^21) {t_setup:.1f} s "
          f"(host C++ SRS, cold cache)")
    t0 = time.perf_counter()
    table = key.table()
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    small = scalar_ints(random_words(rng, BN254_G1.order, 64))
    got = key.commit(small + [0] * (COMMITS[0] - 64))
    check(got == BN254_G1.pippenger(small, key.gens[:64]),
          "2^20 vector with 64 non-zero scalars differs from the host")
    print(f"  table on the card {t_table:.1f} s; the 2^20 vector with 64 "
          f"non-zero scalars equals the host Pippenger")

    # 4.3 the main path: commits through CommitmentKey
    vecs = {n: random_words(rng, BN254_G1.order, n) for n in COMMITS}
    ints = {n: scalar_ints(w) for n, w in vecs.items()}
    t0 = time.perf_counter()
    gkey = CommitmentKey.setup(GRUMPKIN, b"lurk_tpu.ck.grumpkin",
                               CK_GRUMPKIN, dev)
    gkey.table()
    torch.cuda.synchronize()
    print(f"  CommitmentKey.setup(Grumpkin, 2^16) and its table "
          f"{time.perf_counter() - t0:.1f} s (host C++ Pedersen, cold)")
    gvec = random_words(rng, GRUMPKIN.order, CK_GRUMPKIN)
    gints = scalar_ints(gvec)
    M.launches = 0
    commits, host_s = {}, {}
    for n in COMMITS:
        t0 = time.perf_counter()
        commits[n] = key.commit(ints[n])
        host_s[n] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpoint = gkey.commit(gints)
    host_s["g"] = time.perf_counter() - t0
    launches = M.launches
    check(launches == 3, f"{launches} MSM launches for 3 commits")
    gw = words_on(gkey.table(), gvec)
    check(gpoint == M.to_affine(GRUMPKIN, M.msm_plain(
        GRUMPKIN, gkey.table().rows, gw)),
        "Grumpkin 2^16 commit differs from the plain version")
    # the 2^20 commit against the plain version on the card, over lane
    # chunks (its temporaries take some 70 KB a lane) whose partial
    # points are summed on the host
    n20 = COMMITS[0]
    w20 = words_on(table, vecs[n20])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain20 = None
    for lo in range(0, n20, PLAIN_CHUNK):
        part = M.msm_plain(BN254_G1, table.rows[lo:lo + PLAIN_CHUNK],
                           w20[lo:lo + PLAIN_CHUNK])
        plain20 = BN254_G1.add(plain20, M.to_affine(BN254_G1, part))
    plain_ms = 1e3 * (time.perf_counter() - t0)
    max_err = max(max_err, point_err(commits[n20], plain20))
    check(commits[n20] == plain20,
          "BN254 2^20 commit differs from the plain version")
    print(f"phase 4.3: the BN254 2^20 commit equals the plain version on "
          f"the card ({n20 // PLAIN_CHUNK} chunks of {PLAIN_CHUNK} lanes, "
          f"{plain_ms:.1f} ms, host clock)")

    ms = bound_ms = 0.0
    bound_by = set()
    shapes = [(f"BN254 G1 n=2^{n.bit_length() - 1}", table, vecs[n],
               host_s[n]) for n in COMMITS]
    shapes.append(("Grumpkin n=2^16", gkey.table(), gvec, host_s["g"]))
    for label, tab, words, hs in shapes:
        w = words_on(tab, words)
        k_ms = time_ms(lambda: M.msm_words(tab, w), TIMED_LAUNCHES)
        b_ms, by, madds = bound.msm(words, tab.n)
        print(f"  commit {label}: kernel {k_ms:.3f} ms/launch (CUDA events, "
              f"{TIMED_LAUNCHES} launches), whole commit {hs:.3f} s (host "
              f"clock: packing, kernel, affine); bound {b_ms:.3f} ms ({by}: "
              f"{madds} mixed additions), {b_ms / k_ms:.1%} of it")
        ms, bound_ms = ms + k_ms, bound_ms + b_ms
        bound_by.add(by)

    # 4.4 the sharded table over one card twice
    t0 = time.perf_counter()
    stab = sharding.ShardedMsmTable(devices, BN254_G1,
                                    key.gens[:COMMITS[0]])
    check(stab.msm(ints[COMMITS[0]]) == commits[COMMITS[0]],
          "two-shard MSM at 2^20 differs from the single table")
    sharding._PROVER_DEVICES = devices
    check(key.commit(ints[COMMITS[1]]) == commits[COMMITS[1]],
          "sharded CommitmentKey.commit at 2^21 differs from the table")
    sharding._PROVER_DEVICES = None
    print(f"phase 4.4: two shards on [cuda:0, cuda:0] equal the single "
          f"table at 2^20 and (through CommitmentKey) at 2^21 "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"name": "msm", "route": "cuda",
            "source": "lurk_tpu_torch/csrc/msm.cu",
            "replaces": "lurk_tpu/msm/device_v2.py:249",
            "launches": launches, "mismatches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "plain_n": n20,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by
            else "bytes", "library_ms": None}, key


def phase5(bound, gen, dev, host, devices):
    """K2: checks, anchors, the sharded hydration main path, size."""
    from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit
    from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS
    from lurk_tpu_torch.lem.evaluation import evaluate
    from lurk_tpu_torch.parallel import sharding
    from lurk_tpu_torch.parser import read_with_default_state
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.store import core
    from lurk_tpu_torch.store.core import Store
    from lurk_tpu_torch.symbol import user_sym

    t0 = time.perf_counter()
    max_err = poseidon_against_plain(
        FIELDS, gen, dev, K.poseidon_hash_dense, K.poseidon_hash_dense_plain,
        "dense")
    check(K.hash_batch_dense(BN256_SCALAR, 3, [[0, 4, 0]], device=dev)
          == [COMMIT_NUM0], "commit(Num(0)) anchor through K2")
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch_dense(BN256_SCALAR, 8, [[h] * 8], device=dev)
        check(h == want, "trie empty-root anchor through K2")
    sharding._PROVER_DEVICES = devices
    anchor = Store(BN256_SCALAR, device=dev)
    xs = anchor.intern_symbol(user_sym("x"))
    fun = anchor.intern_fun(anchor.list([xs]), xs, anchor.intern_empty_env())
    threshold, core._DEVICE_WAVE_THRESHOLD = core._DEVICE_WAVE_THRESHOLD, 1
    before = K.dense_launches
    anchor.hydrate_z_cache()            # every wave through K2, sharded
    core._DEVICE_WAVE_THRESHOLD = threshold
    check(K.dense_launches > before, "the anchor's waves missed K2")
    z = anchor.hash_ptr(fun)
    check(K.hash_batch_dense(BN256_SCALAR, 3, [[0, z.tag, z.digest]],
                             device=dev) == [COMMIT_ID_FUN],
          "(lambda (x) x) commitment anchor through K2")
    print(f"phase 5.1: dense kernel = plain = host oracle on 16 "
          f"field/arity pairs at B={PHASE1_BATCH}; anchors hold through "
          f"K2 ({time.perf_counter() - t0:.1f} s)")

    # the main path: fib(100) hydrated over two prover devices
    big = []                            # (arity, size) of sharded waves
    shard_ints = sharding.shard_hash_batch_ints

    def recording(devs, field, arity, pres):
        big.append((arity, len(pres)))
        return shard_ints(devs, field, arity, pres)

    sharding.shard_hash_batch_ints = recording
    K.dense_launches = 0
    K.launches = 0
    t0 = time.perf_counter()
    store = Store(BN256_SCALAR, device=dev)
    frames = evaluate(None, read_with_default_state(store, FIB_PROGRAM),
                      store, fib_limit(100, 100))
    store.hydrate_z_cache()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, sparse = K.dense_launches, K.launches
    sharding.shard_hash_batch_ints = shard_ints
    sharding._PROVER_DEVICES = None
    check(len(frames) == 800, f"{len(frames)} frames, expected 800")
    check(launches == 2 * len(big) and launches > 0 and sparse == 0,
          f"{launches} dense and {sparse} sparse launches for "
          f"{len(big)} sharded waves")
    for iv, d in store.z_cache.items():
        check(host.hash_ptr_val(iv) == d, f"hydrated digest of {iv} differs")
    print(f"phase 5.2: fib(100) over [cuda:0, cuda:0]: {len(frames)} "
          f"frames, {len(big)} sharded waves {big}, {launches} K2 launches "
          f"(0 of K1); evaluate + hydrate {t_run:.2f} s; "
          f"{len(store.z_cache)} digests equal host hashing")

    const_bytes = {a: K.dense_constants(BN256_SCALAR, a, dev).numel() * 4
                   for a in (3, 4, 6, 8)}
    ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    for arity, n in big:
        per = sharding._per_shard(n, 2)
        x = random_preimages(BN256_SCALAR, arity, per, gen, dev)
        max_err = max(max_err, compare(BN256_SCALAR, arity, x,
                                       K.poseidon_hash_dense,
                                       K.poseidon_hash_dense_plain)[0])
        k_ms = time_ms(lambda: K.poseidon_hash_dense(BN256_SCALAR, arity, x),
                       20)
        p_ms = time_ms(
            lambda: K.poseidon_hash_dense_plain(BN256_SCALAR, arity, x), 1)
        b_ms, by = bound.of(BN256_SCALAR, arity, per, const_bytes[arity])
        print(f"  wave arity {arity} B={n}, 2 shards of {per}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.1f} ms, bound {b_ms:.6f} ms "
              f"({by}) per shard")
        ms, plain_ms = ms + 2 * k_ms, plain_ms + 2 * p_ms
        bound_ms += 2 * b_ms
        bound_by.add(by)

    for name, b in DENSE_SIZES:
        field = FIELDS[name]
        x = random_preimages(field, 4, b, gen, dev)
        k_ms = time_ms(lambda: K.poseidon_hash_dense(field, 4, x),
                       TIMED_LAUNCHES)
        b_ms, by = bound.of(field, 4, b, const_bytes[4])
        print(f"phase 5.3: dense Poseidon-4 {name} B=2^{b.bit_length() - 1}:"
              f" {k_ms:.3f} ms/launch, {b / k_ms * 1e3:,.0f} hashes/s; bound "
              f"{b_ms:.3f} ms ({by}: {imad_per_hash(field, 4)} IMAD per "
              f"hash, the digest's least work), {b_ms / k_ms:.1%} of it; "
              f"the dense schedule does {imad_per_hash(field, 4, dense=True)}"
              f" IMAD per hash")
    return {"name": "poseidon_dense", "route": "cuda",
            "source": "lurk_tpu_torch/csrc/poseidon_dense.cu",
            "replaces": "lurk_tpu/poseidon/pallas_nib12.py:125",
            "launches": launches, "mismatches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by
            else "bytes", "library_ms": None}


def run_bench(schedule: str) -> dict:
    """``python -m lurk_tpu_torch.bench --schedule <schedule>`` from the
    repository root: its output must be exactly one JSON line."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "lurk_tpu_torch.bench", "--schedule",
         schedule], cwd=root, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    check(out.returncode == 0,
          f"bench --schedule {schedule} exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    check(len(lines) == 1, f"bench --schedule {schedule} printed "
          f"{len(lines)} lines")
    line = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "msm_2e20_ms",
            "msm_2e20_pipelined_ms"}
    check(set(line) == keys and line["value"] > 0,
          f"bench --schedule {schedule}: unexpected line {lines[0]}")
    print(f"  python -m lurk_tpu_torch.bench --schedule {schedule} "
          f"({time.perf_counter() - t0:.1f} s): {lines[0]}")
    return line


def phase6(bound, gen, dev):
    """The folded Poseidon: checks, anchors, the bench path, size."""
    from lurk_tpu_torch import bench
    from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS, PALLAS_SCALAR
    from lurk_tpu_torch.poseidon import kernel as K

    t0 = time.perf_counter()
    max_err = poseidon_against_plain(
        FIELDS, gen, dev, K.poseidon_hash_folded,
        K.poseidon_hash_folded_plain, "folded")
    check(K.hash_batch_folded(BN256_SCALAR, 3, [[0, 4, 0]], device=dev)
          == [COMMIT_NUM0], "commit(Num(0)) anchor through the folded kernel")
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch_folded(BN256_SCALAR, 8, [[h] * 8], device=dev)
        check(h == want, "trie empty-root anchor through the folded kernel")
    print(f"phase 6.1: folded kernel = plain = host oracle on 16 "
          f"field/arity pairs at B={PHASE1_BATCH}; anchors hold "
          f"({time.perf_counter() - t0:.1f} s)")

    # the main path: the bench's Poseidon-4 run through the folded kernel
    K.folded_launches = 0
    t0 = time.perf_counter()
    line = bench.poseidon_bench("folded", dev)
    launches = K.folded_launches
    check(launches == bench.TIMED + 1,
          f"{launches} folded launches for the bench's {bench.TIMED} + 1")
    print(f"phase 6.2: bench.poseidon_bench('folded'): {launches} folded "
          f"launches at B=2^{bench.BATCH.bit_length() - 1}, "
          f"{line['value']:,.0f} hashes/s (host clock) "
          f"({time.perf_counter() - t0:.1f} s)")

    const_bytes = K.folded_constants(PALLAS_SCALAR, 4, dev).numel() * 4
    rows = {}
    for b in (bench.BATCH, 1 << 20):
        x = random_preimages(PALLAS_SCALAR, 4, b, gen, dev)
        k_ms = time_ms(lambda: K.poseidon_hash_folded(PALLAS_SCALAR, 4, x),
                       TIMED_LAUNCHES)
        b_ms, by = bound.of(PALLAS_SCALAR, 4, b, const_bytes)
        text = (f"phase 6.3: folded Poseidon-4 pallas B=2^"
                f"{b.bit_length() - 1}: {k_ms:.3f} ms/launch, "
                f"{b / k_ms * 1e3:,.0f} hashes/s; bound {b_ms:.3f} ms ({by}: "
                f"{imad_per_hash(PALLAS_SCALAR, 4)} IMAD per hash, the "
                f"digest's least work), {b_ms / k_ms:.1%} of it; the folded "
                f"schedule needs {imad_per_hash(PALLAS_SCALAR, 4, folded=True)}"
                f" IMAD per hash")
        p_ms = None
        if b == bench.BATCH:
            max_err = max(max_err, compare(
                PALLAS_SCALAR, 4, x, K.poseidon_hash_folded,
                K.poseidon_hash_folded_plain)[0])
            p_ms = time_ms(lambda: K.poseidon_hash_folded_plain(
                PALLAS_SCALAR, 4, x), 1)
            text += f"; plain {p_ms:.0f} ms (equal digests)"
        print(text)
        rows[b] = (k_ms, p_ms, b_ms, by)
    run_bench("folded")
    run_bench("sparse")
    k_ms, p_ms, b_ms, by = rows[bench.BATCH]
    return {"name": "poseidon_folded", "route": "cuda",
            "source": "lurk_tpu_torch/csrc/poseidon_folded.cu",
            "replaces": "lurk_tpu/poseidon/pallas_nib.py:344",
            "also_replaces": "lurk_tpu/poseidon/pallas_mxu.py:324",
            "launches": launches, "mismatches": 0, "max_abs_err": max_err,
            "ms": launches * k_ms, "plain_ms": launches * p_ms,
            "bound_ms": launches * b_ms, "bound_by": by, "library_ms": None}


def phase7(dev, store, frames, key) -> None:
    """The step circuit and the main path's witnesses and commitments."""
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.lem.circuit import synthesize_frame
    from lurk_tpu_torch.lem.eval_step import eval_step
    from lurk_tpu_torch.lem.interpreter import Frame
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof.multiframe import MultiFrame, io_chain_checker
    from lurk_tpu_torch.r1cs.cs import ConstraintSystem

    step = eval_step()
    t0 = time.perf_counter()
    blank = ConstraintSystem(BN256_SCALAR)
    synthesize_frame(blank, step, store, Frame.blank_frame(step, 0, store))
    check((blank.num_constraints, blank.num_aux) == (11057, 9029),
          f"blank step circuit {blank.num_constraints} constraints, "
          f"{blank.num_aux} aux; expected 11057 and 9029")
    first = ConstraintSystem(BN256_SCALAR, check=True)
    synthesize_frame(first, step, store, frames[0])
    check(first.is_satisfied() and
          first.shape_digest() == blank.shape_digest(),
          "frame 0 is unsatisfied or its shape differs from the blank's")
    (mf5,) = MultiFrame.from_frames(frames[:CHECK_RC], CHECK_RC, step, store)
    x_full, w_full, _ = mf5.instance(step, store, shape_check=True)
    x_wo, w_wo, _ = mf5.instance(step, store, witness_only=True)
    check(x_wo == x_full and w_wo == w_full,
          "witness-only differs from full synthesis on frames 0-4")
    print(f"phase 7.1: blank step circuit {blank.num_constraints} "
          f"constraints, {blank.num_aux} aux; frame 0 satisfied with the "
          f"blank's shape; witness-only = full synthesis on frames 0-4 at "
          f"rc={CHECK_RC} ({len(w_full)} aux) "
          f"({time.perf_counter() - t0:.1f} s)")

    # the main path: step witnesses of fib(100), each W committed
    K.launches = M.launches = K.dense_launches = K.folded_launches = 0
    t0 = time.perf_counter()
    steps = MultiFrame.from_frames(frames, STEP_RC, step, store)
    xs, w_s, c_s, sizes = [], [], [], set()
    for mf in steps:
        t1 = time.perf_counter()
        x, w, _ = mf.instance(step, store, witness_only=True)
        t2 = time.perf_counter()
        point = key.commit(w)
        c_s.append(time.perf_counter() - t2)
        w_s.append(t2 - t1)
        check(point is not None and key.curve.is_on_curve(point),
              "a commitment of W is not a curve point")
        check(all(0 <= v < BN256_SCALAR.modulus for v in w),
              "W holds a value outside the field")
        xs.append(x)
        sizes.add(len(w))
    t_all = time.perf_counter() - t0
    poseidon = (K.launches, K.dense_launches, K.folded_launches)
    check(len(steps) == len(frames) // STEP_RC == 8,
          f"{len(steps)} folding steps, expected 8")
    check(M.launches == len(steps), f"{M.launches} MSM launches for "
          f"{len(steps)} commits of W")
    check(poseidon == (0, 0, 0), f"Poseidon launches {poseidon} while "
          "synthesizing witnesses (the store was hydrated in phase 2)")
    check(len(sizes) == 1, f"W sizes differ across steps: {sorted(sizes)}")
    check(io_chain_checker(xs[0][:6], xs[-1][6:])(xs),
          "step inputs and outputs do not chain")
    print(f"phase 7.2: fib(100) -> MultiFrame.from_frames(rc={STEP_RC}): "
          f"{len(steps)} steps, W of {sizes.pop()} entries each; witness "
          f"(witness-only, host C++ trace) {statistics_line(w_s)} s per "
          f"step; commit of W (2^{key.table().n.bit_length() - 1}-point "
          f"BN254 key, K6) {statistics_line(c_s)} s per step; "
          f"{M.launches} MSM launches; {t_all:.1f} s in all")


def statistics_line(values) -> str:
    """"mean (min-max)" of a list of seconds."""
    return (f"{sum(values) / len(values):.3f} ({min(values):.3f}-"
            f"{max(values):.3f})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from lurk_tpu_torch import native
    from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit
    from lurk_tpu_torch.fields import BN256_SCALAR, FIELDS
    from lurk_tpu_torch.lem.evaluation import evaluate
    from lurk_tpu_torch.parser import read_with_default_state
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.store import core
    from lurk_tpu_torch.store.core import Store
    from lurk_tpu_torch.symbol import user_sym

    # parameter caches live in the checkout's build directory, cold
    cache = Path(__file__).resolve().parent / "lurk_tpu_torch" / "_build" \
        / "cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["LURK_TPU_CACHE"] = str(cache)
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- phase 0: card and build ----
    smi = nvidia_smi("name,power.limit")
    clock = float(nvidia_smi("clocks.max.sm", ",nounits"))
    props = torch.cuda.get_device_properties(0)
    bound = Bound(props.multi_processor_count, clock)
    print(f"card: {smi}; {props.multi_processor_count} SMs, max SM clock "
          f"{clock:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    times = native.build_many(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(SOURCES)} "
          f"sources at once (nvcc, sm_90a)")
    for name in SOURCES:
        print(f"  {name}.cu: {times[name]:.1f} s")
        for line in native.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())
    t0 = time.perf_counter()
    host_times = native.build_host()
    print(f"host C++ (g++, at once): {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{n}.cpp {s:.1f} s" for n, s in host_times.items()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # ---- phase 1: kernel against plain, oracle and anchors ----
    t0 = time.perf_counter()
    max_err = poseidon_against_plain(FIELDS, gen, dev, K.poseidon_hash,
                                     K.poseidon_hash_plain, "sparse")
    check(K.hash_batch(BN256_SCALAR, 3, [[0, 4, 0]], device=dev)
          == [COMMIT_NUM0], "commit(Num(0)) anchor through the kernel")
    h = 0
    for want in TRIE_ROOTS:
        (h,) = K.hash_batch(BN256_SCALAR, 8, [[h] * 8], device=dev)
        check(h == want, "trie empty-root anchor through the kernel")
    anchor = Store(BN256_SCALAR, device=dev)
    xs = anchor.intern_symbol(user_sym("x"))
    fun = anchor.intern_fun(anchor.list([xs]), xs, anchor.intern_empty_env())
    threshold, core._DEVICE_WAVE_THRESHOLD = core._DEVICE_WAVE_THRESHOLD, 1
    before = K.launches
    anchor.hydrate_z_cache()            # every wave through the kernel
    core._DEVICE_WAVE_THRESHOLD = threshold
    check(K.launches > before, "the anchor's waves missed the kernel")
    z = anchor.hash_ptr(fun)
    check(K.hash_batch(BN256_SCALAR, 3, [[0, z.tag, z.digest]], device=dev)
          == [COMMIT_ID_FUN], "(lambda (x) x) commitment anchor")
    print(f"phase 1: 16 field/arity pairs at B={PHASE1_BATCH}, 0 "
          f"mismatches, anchors hold ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 2: main path ----
    big = []                            # (arity, size) of batched waves

    def recording_hash_batch(field, arity, pres, device=None):
        big.append((arity, len(pres)))
        return K.hash_batch(field, arity, pres, device)

    core.hash_batch = recording_hash_batch
    K.launches = 0
    t0 = time.perf_counter()
    store = Store(BN256_SCALAR, device=dev)
    expr = read_with_default_state(store, FIB_PROGRAM)
    frames = evaluate(None, expr, store, fib_limit(100, 100))
    t_eval = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.hydrate_z_cache()
    torch.cuda.synchronize()
    t_hyd = time.perf_counter() - t0
    launches = K.launches
    core.hash_batch = K.hash_batch
    check(len(frames) == 800, f"{len(frames)} frames, expected 800")
    check(launches == len(big) and launches > 0,
          f"{launches} launches for {len(big)} batched waves")
    host = Store(BN256_SCALAR, device="cpu")    # hashes with hash_ptr_val
    host_frames = evaluate(None, read_with_default_state(host, FIB_PROGRAM),
                           host, fib_limit(100, 100))
    for iv, d in store.z_cache.items():
        check(host.hash_ptr_val(iv) == d, f"hydrated digest of {iv} differs")
    for f, g in zip(frames, host_frames):
        check([store.hash_ptr(p) for p in f.input + f.output]
              == [host.hash_ptr(p) for p in g.input + g.output],
              "frame z-ptrs differ from host hashing")
    print(f"phase 2: fib(100) {len(frames)} frames, {len(big)} batched "
          f"waves {big}, {launches} kernel launches; "
          f"evaluate {t_eval:.2f} s, hydrate {t_hyd:.3f} s; "
          f"{len(store.z_cache)} digests equal host hashing")

    const_bytes = {a: K.constants(BN256_SCALAR, a, dev).numel() * 4
                   for a in (3, 4, 6, 8)}
    ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    for arity, b in big:
        x = random_preimages(BN256_SCALAR, arity, b, gen, dev)
        max_err = max(max_err, compare(BN256_SCALAR, arity, x,
                                       K.poseidon_hash,
                                       K.poseidon_hash_plain)[0])
        k_ms = time_ms(lambda: K.poseidon_hash(BN256_SCALAR, arity, x), 20)
        p_ms = time_ms(
            lambda: K.poseidon_hash_plain(BN256_SCALAR, arity, x), 1)
        b_ms, by = bound.of(BN256_SCALAR, arity, b, const_bytes[arity])
        print(f"  wave arity {arity} B={b}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.1f} ms, bound {b_ms:.6f} ms ({by})")
        ms, plain_ms, bound_ms = ms + k_ms, plain_ms + p_ms, bound_ms + b_ms
        bound_by.add(by)

    # ---- phase 3: size ----
    for name, b in SIZES:
        field = FIELDS[name]
        x = random_preimages(field, 4, b, gen, dev)
        k_ms = time_ms(lambda: K.poseidon_hash(field, 4, x), TIMED_LAUNCHES)
        b_ms, by = bound.of(field, 4, b, const_bytes[4])
        line = (f"phase 3: Poseidon-4 {name} B=2^{b.bit_length() - 1}: "
                f"{k_ms:.3f} ms/launch, {b / k_ms * 1e3:,.0f} hashes/s; "
                f"bound {b_ms:.3f} ms ({by}: {imad_per_hash(field, 4)} "
                f"IMAD per hash at {bound.imad_per_s:.3e} IMAD/s), "
                f"{b_ms / k_ms:.1%} of it; the kernel's schedule does "
                f"{imad_per_hash(field, 4, kernel_schedule=True)} IMAD "
                f"per hash")
        if b == 1 << 17:
            max_err = max(max_err, compare(field, 4, x, K.poseidon_hash,
                                           K.poseidon_hash_plain)[0])
            p_ms = time_ms(lambda: K.poseidon_hash_plain(field, 4, x), 1)
            line += f"; plain {p_ms:.0f} ms"
        print(line)
    sparse = {
        "name": "poseidon_sparse", "route": "cuda",
        "source": "lurk_tpu_torch/csrc/poseidon.cu",
        "replaces": "lurk_tpu/poseidon/pallas_nib12_opt.py:141",
        "launches": launches, "mismatches": 0, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if "operations" in bound_by else "bytes",
        "library_ms": None,
    }

    # ---- phase 4: K6 ----
    shard_devices = [torch.device("cuda", 0)] * 2
    msm, key = phase4(bound, dev, shard_devices)

    # ---- phase 5: K2 ----
    dense = phase5(bound, gen, dev, host, shard_devices)

    # ---- phase 6: the folded Poseidon and the bench ----
    folded = phase6(bound, gen, dev)

    # ---- phase 7: step witnesses of fib(100), committed through K6 ----
    phase7(dev, store, frames, key)

    print(json.dumps({"kernels": [sparse, dense, msm, folded]}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
