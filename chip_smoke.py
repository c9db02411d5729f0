#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lurk_tpu_torch``) on one GPU.

Usage: python3 chip_smoke.py   (needs one CUDA card, nvcc and g++)

Phases, each fatal on failure:
  0. card: nvidia-smi name and power limit, versions; the kernel sources
     built at once (one nvcc each, with ptxas' registers and stack per
     kernel, and K1's and K2's SASS instructions counted by kind), the
     host C++ with g++; the measured 32-bit IMAD rate
     (csrc/imad_rate.cu) and the SM clock under it, beside the bounds'
     assumed rate;
  0.5 shapes: K1 and K2 each built twice more, from copies of their
     sources whose kThreadFrom sends every batch to one shape (the lane
     group, one thread per hash); both shapes timed at the main path's
     wave sizes and at 2^12-2^20 (Poseidon-4 over Pallas, Poseidon-8 over
     BN256), each launch equal to the launcher's own, beside the shape
     the launcher takes;
  1. K1 against plain: the sparse CUDA Poseidon against its plain
     PyTorch version on the card, 4 fields x arities 3/4/6/8 at a batch
     below its kThreadFrom and one at or above it (both shapes; random
     canonical preimages plus all-0 and all-(p-1) lanes), 8 lanes each
     against the host oracle, and the reference anchors through it in
     both shapes;
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
     single table; times and bounds; then K6 at 2^20 on three skewed
     vectors (all scalars equal, W-like repeated values, 64 non-zero),
     each kind held against the plain version at 2^16, the all-equal one
     at 2^20 by MSM(s, ..., s) = s MSM(1, ..., 1);
  5. K2, the dense Poseidon: against its plain version and the host
     oracle (4 fields x 4 arities, both shapes as in phase 1), the
     anchors through it in both shapes,
     then its main path: fib(100) hydrated with the prover devices set to
     [cuda:0, cuda:0], two launches per batched wave, every digest
     against host hashing; Poseidon-4 at 2^17 and 2^20 against the bound;
  6. the folded Poseidon (csrc/poseidon_folded.cu): against its plain
     version and the host oracle (4 fields x 4 arities at B = 4096), the
     anchors through it, then its main path: the port's bench
     (lurk_tpu_torch/bench.py) Poseidon-4 run through it (11 launches at
     2^17); Poseidon-4 at 2^17 and 2^20 against the bound, each held
     against the plain version (over chunks of 2^17 lanes) and on 8
     lanes against the host oracle; then ``python -m
     lurk_tpu_torch.bench --schedule folded`` as a subprocess, printing
     its one line;
  7. the step circuit: the blank frame's 11,057 constraints and 9,029
     aux, frame 0 of fib(100) fully synthesized with every constraint
     checked, witness-only equal to full synthesis on the first 5 frames
     at rc = 5;
  8. the fold (the Nova IVC), on the first PHASE8_FRAMES frames of
     phase 2's hydrated fib(100):
     NovaProver(rc=100, cuda).prove_from_frames -> the shape from step
     0's full synthesis (its build timed) -> a step a 100 frames of
     witness-only synthesis, W packed once and committed through K6,
     the cross-term T on the host C++ and committed through K6, the
     fold (2 MSM launches a step, no Poseidon launch) ->
     NovaProver.verify (W and E recommitted: 2 launches) accepts, and
     rejects the proof with one entry of its final W changed; each
     step's phase times (host clock), then each commit's kernel timed
     alone (CUDA events) with its bound (none against the plain version
     since phase 14: K6 at about 10^6 BN254 scalars is held by phase
     4.3's 2^20 commit); then spartan.compress
     (HyperKZG's commits through K6) and verify_compressed with the IO
     chain check accept, and reject a changed sumcheck value and a
     dropped last step;
  9. the cycle fold, the reference's main path, on phase 2's store:
     sn_cycle_public_params(rc=100, cuda) built and timed (the primary
     circuit's full synthesis, its digest and save, the secondary's, the
     BN254 2^21 and Grumpkin 2^15 keys) and dropped from memory, then
     SuperNovaCycleProver(rc=100, cuda).prove_from_frames, which loads
     them from the disk cache as a new process would: 8 steps, the
     step witnesses from the fork pool, 16 K6 launches on BN254 (W1 and
     T1 of each step) and 16 on Grumpkin (W2 of each step, T2 of steps
     1-7 and finish's), no Poseidon launch; each step's phase times
     (host clock, ``supernova_cycle.*``) and one step's witness
     synthesized inline beside the pool's waits; verify (4 launches: W
     and E on each curve) accepts and rejects the proof with one entry
     of its final W1 changed; each commit's kernel timed alone with its
     bound, by curve and size class; step 0's W2 and step 1's T2
     against the plain version on the card (not step 0's W1, 922,575
     scalars, for the script's time: K6 at about 10^6 BN254 scalars is
     held against its plain version by phases 4.3 and 8);
  10. compression: compress_sn_cycle (Spartan with HyperKZG's commits
     through K6 on BN254, the IPA's MSMs on the host on Grumpkin), its
     phases' times (``spartan.*``), verify_compressed_sn_cycle (no MSM
     launch) accepts and rejects the proof with one sumcheck value
     changed; HyperKZG's K6 commits timed alone with their bounds; then
     fib(100) prove + compress + verify s and frames/s;
  11. the Nova cycle (the JAX REPL's ``nova`` backend), on the first
     PHASE11_FRAMES frames of phase 2's store: cycle_public_params(
     rc=100, cuda) built and timed (the
     primary augmented circuit's full synthesis, its digest and save,
     the secondary's, the BN254 2^21 and Grumpkin 2^15 keys), then
     CycleNovaProver(rc=100, cuda).prove_from_frames with those objects:
     4 steps, the step witnesses from the shared fork pool, 8 K6
     launches on BN254 and 8 on Grumpkin, no Poseidon launch; each
     step's phase times (``nova_cycle.*``);
     verify (2 + 2 launches) accepts and rejects a changed entry of the
     final W1; each commit's kernel timed alone, step 0's W2 against the
     plain version; compress_cycle (HyperKZG through K6, the IPA on the
     host) and verify_compressed_cycle accept, and reject a changed
     sumcheck value;
  12. NIVC (the JAX REPL's ``supernova`` backend), on the first
     PHASE12_FRAMES frames of phase 2's store:
     SuperNovaProver(rc=100, Lang(), cuda).prove_from_frames, its
     ``-nivc`` shape built and saved in the prove (timed apart), 1
     witness inline, W and T of 2 steps through K6 (4 launches);
     verify (2 launches) accepts and rejects a changed final witness
     entry; each commit's kernel timed alone; compress and
     verify_compressed accept, and reject a changed step input and a
     proof with no Spartan proofs; a HyperKZG chain commit of 2^12
     scalars against the plain version;
  13. the CLI (``lurk_tpu_torch.cli``): ``load <fib(100)> --rc 100
     --limit 800 --prove`` through its ``main`` in this process, with
     the default device (cuda) and backend (supernova-cycle, compressed,
     self-checked), the public parameters dropped from memory so that
     they load from the disk cache: 800 iterations, K1 on the CLI
     store's batched waves and K6 on both curves, the persisted proof
     file equal to phase 10's compressed proof; ``python -m
     lurk_tpu_torch.cli verify`` in a child process exits 0; ``inspect``;
     a copy with one sumcheck value changed is rejected (exit 1); each
     part's seconds beside PERF.md's prediction; the CLI's K1 waves and
     K6 commits timed alone (their launches and times are in the
     kernels line with the other phases');
  14. coprocessors: the trie program (the reference's trie_nivc.rs,
     1,590 frames, 5 of them coprocessor frames) read and evaluated on
     a Store(BN256, cuda), its result 12688603180, hydrated through K1
     (a launch a batched wave, every digest against host hashing), each
     wave's kernel timed alone; the sha256 NIVC proof (BASELINE.md's
     config 5, ``(sha256_nivc_1 1)`` at rc = 10) through
     SuperNovaCycleProver: its public parameters cold and timed (two
     primary circuits, keys BN254 2^18 and Grumpkin 2^15, the SRS read
     from the disk cache at that length), 3 steps through the fork pool
     (6 + 6 K6 launches), the sha256 step's W1 against the plain
     version, verify (4 + 2) and a changed final W1 rejected,
     compress_sn_cycle and its verifier with a changed sumcheck value;
     then the same program through SuperNovaProver(rc=10) as
     scripts/torch_sha256_nivc.py proves and verifies it (10 K6
     launches), supernova.compress and verify_compressed with a changed
     input of the sha256 step; prove, compress and verify seconds
     beside PERF.md's prediction. Phase 14's launches and times are in
     the kernels line;
  15. the circom coprocessor: a square chain of 16,384 rows
     (x_{i+1} = x_i * x_i, circom's wire order, over its bn128 prime)
     written as ``.r1cs`` and ``.wtns`` and packaged by ``python -m
     lurk_tpu_torch.cli circom`` in a child process, loaded, and
     ``(square_chain 7)`` evaluated on a Store(BN256, cuda) to
     7^(2^16384) mod r; SuperNovaProver(rc=10) proves it (both shapes
     cold and timed apart, 6 K6 launches), verify (4 launches) accepts
     and rejects a changed entry of the circom circuit's final W, the
     circom step's W equals the plain version, supernova.compress and
     verify_compressed accept and reject a changed input of the circom
     step; prove, compress and verify seconds beside PERF.md's
     prediction. Its K6 launches and times are in the kernels line;
  16. the memoset coroutines: the sample toplevel's ``(even 100)`` (101
     queries) on a Store(BN256, cuda) scope at rc = 10, its transcript
     hydrated through K1 (a launch a batched wave, every digest and r
     against host hashing), each wave's kernel timed alone;
     MemosetCycleProver(rc=10, cuda): public parameters cold (3 primary
     circuits, no disk cache), 11 steps starting at circuit 1 (22 + 22
     K6 launches), step 0's W1 against the plain version, verify (6 + 2)
     accepts and rejects a changed zn[7]; ``(factorial 29)`` through
     MemosetProver(rc=10, cuda) (6 + 2 launches; a changed zi[7] and a
     changed step input rejected); tests/test_memoset_env.py's two env
     lookups through MemosetProver(rc=2, cuda); each part's seconds
     beside PERF.md's prediction. Its K1 and K6 launches and times are in
     the kernels line;
  17. the chain server (``lurk_tpu_torch.cli.chain_server``) at rc = 10
     on CUDA stores: ChainState over the commit counter behind ``serve``
     on a free local port (GET /config; POST /chain 9 without a proof and
     12 with one: results 9 and 21, the Nova cycle's public parameters
     cold, the proof compressed and verified); StreamState over the
     plain counter with a session file (proving calls 3 and 4, the
     session resumed in a fresh CUDA store with its accumulator equal to
     the dump, a proving call 5: results 3, 7 and 12, one proof across
     the calls, its finish() verified); ``python -m
     lurk_tpu_torch.cli.chain_server --device cuda`` in a child (/config
     and /chain without a proof, then interrupted). Each call runs with
     every count at 0 and prints its prove, compress and verify seconds,
     its K1 waves and its K6 launches with their kernels timed alone;
     the session dumps' sizes and write times. Its launches and times
     are in the kernels line;
  18. the example and bench entry points (scripts/torch_*.py), through
     their functions in this process: ``torch_benches.trie_prove`` on
     phase 14's evaluated and hydrated trie store at rc = 100 (the trie
     Lang's public parameters cold and timed; 25 steps, 20 Lurk and 5
     coprocessor, through the fork pool; verify; K6 launches by curve;
     the result 12688603180; a changed final W1 rejected; the first
     coprocessor step's W1 against the plain version);
     ``torch_sha256_ivc.prove_sha256_ivc``: ``(sha256_ivc_1 1)`` through
     NovaProver(rc=10, cuda), the inlined step's shape cold in the prove,
     1 step, verify, a changed final W rejected; the synthesis bench at
     rc = 100 on phase 2's store; itcalc's default table. Each part's
     seconds beside PERF.md's prediction; its K1 waves and K6 launches
     and times are in the kernels line.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card or without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20240601
PHASE1_SMALL = 100             # a batch the lane-group shape takes
PHASE1_BATCH = 4096            # ... raised to kThreadFrom for the other
# phase 0.5: (field, arity) and batches at which both shapes are timed
SHAPE_SWEEP = [("pallas", 4), ("bn256", 8)]
SWEEP_SIZES = [64, 114, 128, 226, 256, 344] + [1 << k for k in range(12, 21)]
FORCED = {"group": "1LL << 62", "thread": "0"}   # kThreadFrom per shape
SIZES = [("pallas", 1 << 17), ("pallas", 1 << 20), ("bn256", 1 << 20)]
DENSE_SIZES = [("pallas", 1 << 17), ("pallas", 1 << 20)]
TIMED_LAUNCHES = 10
MSM_CHECK_N = 1 << 12
CK_BN254 = 1 << 21            # fib(100)'s primary key: max(aux, constraints)
COMMITS = (1 << 20, 1 << 21)  # W's size (about 100 x 9,029) and the key's
CK_GRUMPKIN = 1 << 16
REPEATED_BASES = 1024          # bench.py:180-184 repeats 1024 points
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# 32-bit integer multiply-adds per clock per SM, compute capability
# 9.0's nominal rate, at the card's maximum SM clock (phase 0 prints the
# IMAD probe's measured rate and the SM clock under it beside this)
IMAD_PER_CLK_PER_SM = 64
# 32-bit multiply-adds (IMAD) per operation on 8 x 32-bit limbs, a wide
# 32x32->64 product counting 2 (low and high word)
PRODUCT = 2 * 64               # a*b: 64 wide products
SQUARE = 2 * 36                # a*a: n(n+1)/2 = 36, cross terms doubled
REDC = 2 * 64 + 8              # Montgomery reduction: m*p, and m itself
MUL = PRODUCT + REDC           # one general field product, 264
REDC_WIDE = 9 * (2 * 8 + 1)    # field.cuh's redc_wide: nine steps, 153
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
SOURCES = ["poseidon", "poseidon_dense", "msm", "poseidon_folded",
           "imad_rate"]
IMAD_BLOCKS_PER_SM = 8         # 2048 threads an SM for the IMAD probe
IMAD_THREADS = 256
IMAD_ITERS = 1 << 12           # of 64 IMAD: about 4.5 ms a launch
IMAD_LAUNCHES = 400            # long enough to read the SM clock under load
FOLDED_CHUNK = 1 << 17         # lanes per plain folded call at 2^20
SKEW_N = 1 << 20               # K6's three skewed vectors
SKEW_CHECK_N = 1 << 16         # ... and their size against the plain MSM
W_LIKE_VALUES = 50_000         # fib(100)'s W: 49,161 distinct values
W_TIMED = 3                    # timed launches per commit of the fold
BENCH_TIMEOUT_S = 300
STEP_RC = 100                  # fib(100)'s 800 frames in 8 folding steps
# phase 8 (the Nova fold): the frames it folds, cut from 800 to keep
# the whole script inside its time limit with phases 11-14 (the shape,
# and so each commit's width, is the same at 200 frames); no commit of
# it is held against the plain version since phase 14 came
PHASE8_FRAMES = 200
# phase 11 (the Nova cycle): the frames it folds, cut from 800 to pay for
# phase 18 (the same shapes and commit widths at 400 frames, 4 steps)
PHASE11_FRAMES = 400
# phase 12 (NIVC): the frames it folds, cut from 800 to pay for phase 15
# (the same shape and commit widths at 400 frames, 3 inline witnesses
# instead of 7) and to 200 for phase 18 (2 steps, 1 inline witness)
PHASE12_FRAMES = 200
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
    the rebuild t rows of t + rp); with ``kernel_schedule`` what one
    thread of csrc/poseidon.cu (with ``dense``: csrc/poseidon_dense.cu)
    does for a hash: the same S-boxes, each row reduced by redc_wide's
    nine steps, the inputs and the digest converted by full products,
    and a sparse round's s_j += v_hat_j s0 a full product each. (The
    lane-group shape issues more: every lane of a group runs the S-box,
    and in K1 the reduction of the sparse round's row.)"""
    from lurk_tpu_torch.poseidon.spec import poseidon_spec
    spec = poseidon_spec(field, arity)
    t, rf, rp = spec.width, spec.full_rounds, spec.partial_rounds
    sboxes, dense_rows, sparse = rf * t + rp, rf * t, rp
    def row(k):
        return k * PRODUCT + REDC
    sbox = 2 * (SQUARE + REDC) + row(1)     # x^2, x^4, x^5
    if kernel_schedule:
        def krow(k):
            return k * PRODUCT + REDC_WIDE
        convert = (arity + 1) * MUL
        if dense:
            return convert + sboxes * sbox + (rf + rp) * t * krow(t)
        return (convert + sboxes * sbox + dense_rows * krow(t)
                + sparse * (krow(t) + (t - 1) * MUL))
    convert = arity * row(1) + REDC         # inputs in, the digest out
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
        """The MSM of these reduced scalar words at its least work over
        the signed window widths c = 1 .. MSM_BOUND_MAX_C, from this
        run's digits: in each window one mixed addition for each
        non-zero digit that is not the first of its bucket, and 2
        additions per bucket up to the highest occupied one for the
        running sums (the windows' doublings left out); bytes: the table, the scalars and the
        result once. Returns (ms, bound_by, the least width, its mixed
        additions)."""
        ops, c, madds = least_msm_work(words)
        nbytes = table_rows * 64 + words.shape[0] * 32 + 96
        return (*self._max(ops, nbytes), c, madds)


def longest_bucket_run(words: np.ndarray) -> int:
    """The longest bucket run of these scalar words at K6's own 16-bit
    windows (host numpy)."""
    from lurk_tpu_torch.msm.kernel import (
        C_BITS, N_BUCKETS, digits_from_words)
    return max(int(np.bincount(win, minlength=N_BUCKETS + 1)[1:].max())
               for win in digits_from_words(words, C_BITS)[0])


MSM_BOUND_MAX_C = 22


def msm_digits(w: torch.Tensor, c: int) -> torch.Tensor:
    """Every window's signed digit of width ``c`` (top window unsigned,
    as K6's) of the scalars ``w`` (int64[n, 8] of 32-bit words), as
    magnitudes in int64[windows, n]. The digits below the top window lie
    in [1 - 2^(c-1), 2^(c-1)]; such a recoding is unique, so they are
    the windows of s + H less 2^(c-1) - 1, with H = (2^(c-1) - 1) in
    every window but the top one: one carried addition of H instead of
    a carry window by window."""
    n_win = -(-256 // c)
    half = 1 << (c - 1)
    offset = sum((half - 1) << (c * win) for win in range(n_win - 1))
    s = torch.empty((w.shape[0], 9), dtype=torch.int64, device=w.device)
    carry = 0
    for k in range(8):
        t = w[:, k] + ((offset >> (32 * k)) & 0xFFFFFFFF) + carry
        s[:, k] = t & 0xFFFFFFFF
        carry = t >> 32
    s[:, 8] = carry
    bits = [win * c for win in range(n_win)]
    lo = torch.tensor([b // 32 for b in bits], device=w.device)
    sh = torch.tensor([b % 32 for b in bits], device=w.device)[:, None]
    # the top window holds up to c + 1 bits (s + H < 2^257)
    mask = torch.tensor([(1 << c) - 1] * (n_win - 1) + [(1 << (c + 1)) - 1],
                        device=w.device)[:, None]
    d = ((s[:, lo].T >> sh) | (s[:, lo + 1].T << (32 - sh))) & mask
    d[:n_win - 1] = (d[:n_win - 1] - (half - 1)).abs()
    return d


def least_msm_work(words: np.ndarray):
    """(IMAD count, width, mixed additions) of the cheapest signed-window
    bucket MSM of ``uint32[n, 8]`` scalar words over the widths 1 ..
    MSM_BOUND_MAX_C (top window unsigned, as K6's), counted on the card
    with torch (no kernel of the port). In each window one mixed
    addition for each non-zero digit that is not the first of its
    bucket, and 2 additions a bucket up to the highest occupied one. A
    width whose lower bound (every non-zero digit but one a possible
    bucket value) exceeds the work already found is not counted
    exactly: it can be neither the least nor tie with it."""
    w = torch.from_numpy(np.ascontiguousarray(words).astype(np.int64)) \
        .to("cuda")
    n = w.shape[0]

    def exact(c, d, sums):
        bins = int(d.max()) + 1
        offsets = torch.arange(d.shape[0], device="cuda")[:, None] * bins
        sizes = torch.bincount((d + offsets).flatten(),
                               minlength=d.shape[0] * bins) \
            .view(-1, bins)[:, 1:]
        madds = int(sizes.sum() - torch.count_nonzero(sizes))
        return madds * MADD + 2 * sums * ADD, c, madds

    # an upper bound first, at about the width a bucket MSM of n takes
    c0 = min(max(n.bit_length() - 4, 1), MSM_BOUND_MAX_C)
    d = msm_digits(w, c0)
    first = exact(c0, d, int(d.max(dim=1).values.sum()))
    best = None
    for c in range(1, MSM_BOUND_MAX_C + 1):
        if c == c0:
            got = first
        else:
            d = msm_digits(w, c)
            sums = int(d.max(dim=1).values.sum())
            n_win, half = d.shape[0], 1 << (c - 1)
            lower = (int(torch.count_nonzero(d)) - (n_win - 1) *
                     min(half, n) - min(2 * half, n)) * MADD + 2 * sums * ADD
            if lower > min(first[0], best[0] if best else first[0]):
                continue
            got = exact(c, d, sums)
        if best is None or got[0] < best[0]:
            best = got
    return best


def compare(field, arity, x, hash_fn, plain_fn):
    """Kernel against plain on the same input: (max |diff|, digests)."""
    got = hash_fn(field, arity, x)
    want = plain_fn(field, arity, x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    mism = int((got != want).any(dim=0).sum())
    check(mism == 0, f"{field.name}/{arity}: {mism} lanes differ from plain")
    return err, got


def poseidon_against_plain(fields, gen, dev, hash_fn, plain_fn, what,
                           batches):
    """Phases 1 and 5.1: 4 fields x 4 arities at each batch size, 8 lanes
    each against the host oracle; returns the max |diff|."""
    from lurk_tpu_torch.poseidon.host import hash_preimage
    max_err = 0
    for name, field in fields.items():
        for b in batches:
            for arity in (3, 4, 6, 8):
                x = random_preimages(field, arity, b, gen, dev)
                err, out = compare(field, arity, x, hash_fn, plain_fn)
                max_err = max(max_err, err)
                lanes = [0, 1, 2, 3, b // 4, b // 2, b - 2, b - 1]
                pres = [lane_ints(x[a], lanes) for a in range(arity)]
                want = [hash_preimage(field,
                                      [pres[a][j] for a in range(arity)])
                        for j in range(len(lanes))]
                check(lane_ints(out, lanes) == want,
                      f"{what} {name}/{arity} B={b}: differs from the host "
                      f"oracle")
    return max_err


def shape_batches(name: str):
    """Phase 1's and 5.1's batches for kernel ``name``: one each side of
    its kThreadFrom."""
    from lurk_tpu_torch.poseidon import kernel as K
    return [PHASE1_SMALL, max(PHASE1_BATCH, K.thread_from(name))]


def shape_of(name: str, b: int) -> str:
    from lurk_tpu_torch.poseidon import kernel as K
    return "thread" if b >= K.thread_from(name) else "group"


def anchors(hash_batch, name: str, dev, what: str):
    """commit(Num(0)) and the trie roots through ``hash_batch`` in both
    shapes: each preimage alone and repeated kThreadFrom times."""
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.poseidon import kernel as K
    for n in (1, K.thread_from(name)):
        check(set(hash_batch(BN256_SCALAR, 3, [[0, 4, 0]] * n, device=dev))
              == {COMMIT_NUM0}, f"commit(Num(0)) anchor through {what}, "
              f"B={n}")
        h = 0
        for want in TRIE_ROOTS:
            hs = set(hash_batch(BN256_SCALAR, 8, [[h] * 8] * n, device=dev))
            check(hs == {want}, f"trie empty-root anchor through {what}, "
                  f"B={n}")
            h = want


def start_shape_builds():
    """Phase 0.5's libraries: nvcc on copies of csrc/poseidon.cu and
    csrc/poseidon_dense.cu (in the build directory) whose kThreadFrom
    sends every batch to one shape, all started at once. Returns
    {(name, shape): (process, library path)}."""
    from lurk_tpu_torch import native
    out = native.BUILD_DIR / "shapes"
    out.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name in ("poseidon", "poseidon_dense"):
        src = (native.CSRC / f"{name}.cu").read_text()
        for shape, value in FORCED.items():
            text, n = re.subn(r"constexpr long long kThreadFrom = [^;]+;",
                              f"constexpr long long kThreadFrom = {value};",
                              src)
            check(n == 1, f"{name}.cu: no single kThreadFrom to set")
            cu = out / f"{name}_{shape}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            proc = subprocess.Popen(
                [native.nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
                 str(cu), "-o", str(so)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            builds[(name, shape)] = (proc, so)
    return builds


def shape_sweep(builds, gen, dev):
    """Phase 0.5: both shapes of K1 and K2 (the libraries of
    start_shape_builds) timed at SWEEP_SIZES, each launch's digests
    equal to the launcher's own."""
    from lurk_tpu_torch import native
    from lurk_tpu_torch.fields import FIELDS
    from lurk_tpu_torch.poseidon import kernel as K
    t0 = time.perf_counter()
    fns = {}
    for (name, shape), (proc, so) in builds.items():
        out, _ = proc.communicate(timeout=native.BUILD_TIMEOUT_S)
        check(proc.returncode == 0, f"{name}.cu forced to the {shape} shape "
              f"did not build:\n{out[-3000:]}")
        fn = getattr(ctypes.CDLL(str(so)), K._ENTRY[name])
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, p]
        fn.restype = i
        fns[(name, shape)] = fn
    print(f"phase 0.5: both shapes of K1 and K2 (built beside phase 0, "
          f"waited {time.perf_counter() - t0:.1f} s)")
    kernels = {"poseidon": (K.poseidon_hash, K._layout, K.constants),
               "poseidon_dense": (K.poseidon_hash_dense, K._dense_layout,
                                  K.dense_constants)}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name, (hash_fn, layout, consts) in kernels.items():
        worst = 0.0
        for fname, arity in SHAPE_SWEEP:
            field = FIELDS[fname]
            lay = layout(field, arity)
            buf = consts(field, arity, dev)
            for b in SWEEP_SIZES:
                x = random_preimages(field, arity, b, gen, dev)
                want = hash_fn(field, arity, x)
                ms = {}
                for shape in FORCED:
                    out = torch.empty((16, b), dtype=torch.int32, device=dev)
                    args = (ctypes.c_void_p(x.data_ptr()),
                            ctypes.c_void_p(out.data_ptr()),
                            ctypes.c_void_p(buf.data_ptr()), arity, lay.rf,
                            lay.rp, b, stream)

                    def launch():
                        check(fns[(name, shape)](*args) == 0,
                              f"{name} {shape} launch failed")

                    ms[shape] = time_ms(launch, 3 if b >= 1 << 18 else 10)
                    check(torch.equal(out, want), f"{name} {shape} shape "
                          f"differs from the launcher at {fname}/{arity} "
                          f"B={b}")
                taken = shape_of(name, b)
                loss = ms[taken] / min(ms.values()) - 1
                worst = max(worst, loss)
                print(f"  {name} {fname}/{arity} B={b}: group "
                      f"{ms['group']:.4f} ms, thread {ms['thread']:.4f} ms; "
                      f"the launcher takes {taken}"
                      + (f", {loss:.1%} slower than the other" if loss > 0
                         else ""))
        print(f"  {name}: kThreadFrom = {K.thread_from(name)}; the taken "
              f"shape is at most {worst:.1%} slower than the other at the "
              f"sizes above")


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


def skew_vectors(rng, order: int, n: int):
    """K6's skewed inputs of n scalars: [(label, words, the common
    scalar or None)]: every scalar equal (the worst skew: 16 runs of n);
    W-like (a fixed set of W_LIKE_VALUES values drawn from the seed,
    each repeated, with W's shares of 0 and 1: 23% and 2%); 64 non-zero
    scalars, the rest 0 (nearly pure fixed cost)."""
    equal = np.repeat(random_words(rng, order, 8)[3:4], n, axis=0)
    pool = random_words(rng, order, W_LIKE_VALUES)
    wlike = pool[rng.integers(0, W_LIKE_VALUES, n)]
    u = rng.random(n)
    wlike[u < 0.23] = 0
    wlike[(u >= 0.23) & (u < 0.25)] = pool[1]
    sparse = np.zeros((n, 8), dtype=np.uint32)
    sparse[:64] = random_words(rng, order, 64)
    return [("all equal", equal, scalar_ints(equal[:1])[0]),
            ("W-like", wlike, None), ("64 non-zero", sparse, None)]


def skewed(bound, rng, table, random_ms: float, check_plain: bool):
    """Phase 4.5: K6 at SKEW_N on the three skewed vectors (the main
    path's launch: the scalars' rows only); each kind held against the
    plain version at SKEW_CHECK_N (with ``check_plain``), the all-equal
    vector at SKEW_N by MSM(s, ..., s) = s MSM(1, ..., 1) on the host.
    Returns {label: ms}."""
    from lurk_tpu_torch.msm import kernel as M
    curve = table.curve
    t0 = time.perf_counter()
    if check_plain:
        for label, words, _ in skew_vectors(rng, curve.order, SKEW_CHECK_N):
            tab = table.prefix(SKEW_CHECK_N)
            w = words_on(tab, words)
            got = M.to_affine(curve, M.msm_words(tab, w))
            check(got == M.to_affine(curve, M.msm_plain(curve, tab.rows, w)),
                  f"K6 on the {label} vector at 2^16 differs from plain")
    tab = table.prefix(SKEW_N)
    out = {}
    for label, words, scalar in skew_vectors(rng, curve.order, SKEW_N):
        w = words_on(tab, words)
        if scalar is not None:
            ones = words_on(tab, np.repeat(random_words(rng, curve.order, 3)
                                           [1:2], SKEW_N, axis=0))
            check(M.to_affine(curve, M.msm_words(tab, w)) ==
                  curve.mul(scalar, M.to_affine(curve, M.msm_words(tab, ones))),
                  "MSM(s, ..., s) differs from s MSM(1, ..., 1) at 2^20")
        k_ms = out[label] = time_ms(lambda: M.msm_words(tab, w),
                                    TIMED_LAUNCHES)
        b_ms, by, c, madds = bound.msm(words, tab.n)
        longest = longest_bucket_run(words)
        print(f"  K6 2^20 {label}: {k_ms:.3f} ms/launch ({k_ms / random_ms:.2f}"
              f"x the random vector's {random_ms:.3f} ms); bound {b_ms:.3f} "
              f"ms ({by}: {madds} mixed additions at {c}-bit windows), "
              f"{b_ms / k_ms:.1%} of it; longest bucket run {longest}")
    print(f"phase 4.5: K6 on three skewed vectors at 2^20"
          + (" (each kind = plain at 2^16; all equal = s MSM(1..1))"
             if check_plain else "")
          + f" ({time.perf_counter() - t0:.1f} s)")
    return out


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
    b12, by12, *_ = bound.msm(checked["bn254-g1"][1], base.n)
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
    # the 2^20 commit against the plain version on the card
    n20 = COMMITS[0]
    plain20, plain_ms = plain_commit(BN254_G1, table, vecs[n20])
    max_err = max(max_err, point_err(commits[n20], plain20))
    check(commits[n20] == plain20,
          "BN254 2^20 commit differs from the plain version")
    print(f"phase 4.3: the BN254 2^20 commit equals the plain version on "
          f"the card ({n20 // PLAIN_CHUNK} chunks of {PLAIN_CHUNK} lanes, "
          f"{plain_ms:.1f} ms, host clock)")

    # the main path's launches: each commit sends its scalars' rows only
    ms = bound_ms = 0.0
    bound_by = set()
    shapes = [(f"BN254 G1 n=2^{n.bit_length() - 1}", table.prefix(n),
               vecs[n], host_s[n]) for n in COMMITS]
    shapes.append(("Grumpkin n=2^16", gkey.table(), gvec, host_s["g"]))
    k_times = {}
    for label, tab, words, hs in shapes:
        w = words_on(tab, words)
        k_ms = k_times[label] = time_ms(lambda: M.msm_words(tab, w),
                                        TIMED_LAUNCHES)
        b_ms, by, c, madds = bound.msm(words, tab.n)
        longest = longest_bucket_run(words)
        print(f"  commit {label}: kernel {k_ms:.3f} ms/launch (CUDA events, "
              f"{TIMED_LAUNCHES} launches), whole commit {hs:.3f} s (host "
              f"clock: packing, kernel, affine); bound {b_ms:.3f} ms ({by}: "
              f"{madds} mixed additions at {c}-bit windows), "
              f"{b_ms / k_ms:.1%} of it; longest bucket run {longest}")
        ms, bound_ms = ms + k_ms, bound_ms + b_ms
        bound_by.add(by)
    w = words_on(table, vecs[n20])
    pad_ms = time_ms(lambda: M.msm_words(table, w), TIMED_LAUNCHES)
    print(f"  the 2^20 vector padded to the key's 2^21 rows (the launch "
          f"before commits sent only their rows): kernel {pad_ms:.3f} "
          f"ms/launch")

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
    skewed(bound, rng, table, k_times[shapes[0][0]], check_plain=True)
    return {"name": "msm", "route": "cuda",
            "source": "lurk_tpu_torch/csrc/msm.cu",
            "replaces": "lurk_tpu/msm/device_v2.py:249",
            "launches": launches, "mismatches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by
            else "bytes", "library_ms": None}


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
    batches = shape_batches("poseidon_dense")
    max_err = poseidon_against_plain(
        FIELDS, gen, dev, K.poseidon_hash_dense, K.poseidon_hash_dense_plain,
        "dense", batches)
    anchors(K.hash_batch_dense, "poseidon_dense", dev, "K2")
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
    for n in (1, batches[1]):
        check(set(K.hash_batch_dense(BN256_SCALAR, 3,
                                     [[0, z.tag, z.digest]] * n, device=dev))
              == {COMMIT_ID_FUN},
              f"(lambda (x) x) commitment anchor through K2, B={n}")
    print(f"phase 5.1: dense kernel = plain = host oracle on 16 "
          f"field/arity pairs at B={batches} (group, thread shape); "
          f"anchors hold through K2 in both shapes "
          f"({time.perf_counter() - t0:.1f} s)")

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
        print(f"  wave arity {arity} B={n}, 2 shards of {per} "
              f"({shape_of('poseidon_dense', per)} shape): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.1f} ms, bound {b_ms:.6f} ms "
              f"({by}), {b_ms / k_ms:.2%} of it, per shard")
        ms, plain_ms = ms + 2 * k_ms, plain_ms + 2 * p_ms
        bound_ms += 2 * b_ms
        bound_by.add(by)

    for name, b in DENSE_SIZES:
        field = FIELDS[name]
        x = random_preimages(field, 4, b, gen, dev)
        k_ms = time_ms(lambda: K.poseidon_hash_dense(field, 4, x),
                       TIMED_LAUNCHES)
        b_ms, by = bound.of(field, 4, b, const_bytes[4])
        least = imad_per_hash(field, 4)
        dense_imad = imad_per_hash(field, 4, dense=True)
        print(f"phase 5.3: dense Poseidon-4 {name} B=2^{b.bit_length() - 1}"
              f" ({shape_of('poseidon_dense', b)} shape): {k_ms:.3f} "
              f"ms/launch, {b / k_ms * 1e3:,.0f} hashes/s; bound "
              f"{b_ms:.3f} ms ({by}: {least} IMAD per hash, the digest's "
              f"least work), {b_ms / k_ms:.1%} of it; the dense schedule "
              f"needs {dense_imad} IMAD per hash (at most "
              f"{least / dense_imad:.1%} of the bound), the kernel does "
              f"{imad_per_hash(field, 4, kernel_schedule=True, dense=True)}")
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
        K.poseidon_hash_folded_plain, "folded", [PHASE1_BATCH])
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
        max_err = max(max_err, folded_held(x))
        text += (f"; equal to the plain version ({b // FOLDED_CHUNK} "
                 f"chunk(s) of {FOLDED_CHUNK} lanes) and the host oracle")
        p_ms = None
        if b == bench.BATCH:
            p_ms = time_ms(lambda: K.poseidon_hash_folded_plain(
                PALLAS_SCALAR, 4, x), 1)
            text += f"; plain {p_ms:.0f} ms"
        print(text)
        rows[b] = (k_ms, p_ms, b_ms, by)
    run_bench("folded")
    k_ms, p_ms, b_ms, by = rows[bench.BATCH]
    return {"name": "poseidon_folded", "route": "cuda",
            "source": "lurk_tpu_torch/csrc/poseidon_folded.cu",
            "replaces": "lurk_tpu/poseidon/pallas_nib.py:344",
            "also_replaces": "lurk_tpu/poseidon/pallas_mxu.py:324",
            "launches": launches, "mismatches": 0, "max_abs_err": max_err,
            "ms": launches * k_ms, "plain_ms": launches * p_ms,
            "bound_ms": launches * b_ms, "bound_by": by, "library_ms": None}


def folded_held(x: torch.Tensor) -> int:
    """The folded kernel's Poseidon-4 over Pallas on x (int32[4, 16, B])
    against its plain version over lane chunks of FOLDED_CHUNK and 8
    lanes (the first, the middle, the last) against the host oracle;
    returns the max |diff|."""
    from lurk_tpu_torch.fields import PALLAS_SCALAR
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.poseidon.host import hash_preimage
    b = x.shape[-1]
    got = K.poseidon_hash_folded(PALLAS_SCALAR, 4, x)
    err = 0
    for lo in range(0, b, FOLDED_CHUNK):
        part = got[..., lo:lo + FOLDED_CHUNK]
        want = K.poseidon_hash_folded_plain(
            PALLAS_SCALAR, 4, x[..., lo:lo + FOLDED_CHUNK].contiguous())
        mism = int((part != want).any(dim=0).sum())
        check(mism == 0, f"folded Poseidon-4 at B={b}: {mism} lanes of "
              f"[{lo}, {lo + FOLDED_CHUNK}) differ from plain")
        err = max(err, int((part.to(torch.int64)
                            - want.to(torch.int64)).abs().max()))
    lanes = [0, 1, 2, 3, b // 2, b - 3, b - 2, b - 1]
    pres = [lane_ints(x[a], lanes) for a in range(4)]
    want = [hash_preimage(PALLAS_SCALAR, [pres[a][j] for a in range(4)])
            for j in range(len(lanes))]
    check(lane_ints(got, lanes) == want,
          f"folded Poseidon-4 at B={b} differs from the host oracle")
    return err


def phase7(store, frames) -> None:
    """The step circuit: the blank frame's counts, frame 0 checked, and
    witness-only synthesis against full synthesis."""
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.lem.circuit import synthesize_frame
    from lurk_tpu_torch.lem.eval_step import eval_step
    from lurk_tpu_torch.lem.interpreter import Frame
    from lurk_tpu_torch.proof.multiframe import MultiFrame
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
    print(f"phase 7: blank step circuit {blank.num_constraints} "
          f"constraints, {blank.num_aux} aux; frame 0 satisfied with the "
          f"blank's shape; witness-only = full synthesis on frames 0-4 at "
          f"rc={CHECK_RC} ({len(w_full)} aux) "
          f"({time.perf_counter() - t0:.1f} s)")


def waves_alone(bound, gen, dev, waves):
    """K1 at each batched wave's (arity, B) on random preimages: held
    against its plain version, timed alone (CUDA events) and plain, with
    its bound. Returns (ms, plain ms, bound ms, max abs err, the bounds'
    kinds)."""
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.poseidon import kernel as K
    ms = plain_ms = bound_ms = 0.0
    max_err = 0
    bound_by = set()
    for arity, b in waves:
        x = random_preimages(BN256_SCALAR, arity, b, gen, dev)
        max_err = max(max_err, compare(BN256_SCALAR, arity, x,
                                       K.poseidon_hash,
                                       K.poseidon_hash_plain)[0])
        k_ms = time_ms(lambda: K.poseidon_hash(BN256_SCALAR, arity, x), 20)
        p_ms = time_ms(
            lambda: K.poseidon_hash_plain(BN256_SCALAR, arity, x), 1)
        b_ms, by = bound.of(BN256_SCALAR, arity, b,
                            K.constants(BN256_SCALAR, arity, dev).numel() * 4)
        print(f"  wave arity {arity} B={b} ({shape_of('poseidon', b)} "
              f"shape): kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms, bound "
              f"{b_ms:.6f} ms ({by}), {b_ms / k_ms:.2%} of it")
        ms, plain_ms, bound_ms = ms + k_ms, plain_ms + p_ms, bound_ms + b_ms
        bound_by.add(by)
    return ms, plain_ms, bound_ms, max_err, bound_by


def plain_commit(curve, table, words: np.ndarray):
    """The plain MSM of reduced scalar words against the table's first
    rows, over lane chunks of PLAIN_CHUNK (its temporaries take some 70
    KB a lane) whose partial points are summed on the host; returns
    (affine point, host-clock ms)."""
    from lurk_tpu_torch.msm import kernel as M
    tab = table.prefix(words.shape[0])
    w = words_on(tab, words)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    point = None
    for lo in range(0, tab.n, PLAIN_CHUNK):
        part = M.msm_plain(curve, tab.rows[lo:lo + PLAIN_CHUNK],
                           w[lo:lo + PLAIN_CHUNK])
        point = curve.add(point, M.to_affine(curve, part))
    return point, 1e3 * (time.perf_counter() - t0)


def phase8(bound, store, frames) -> dict:
    """The fold on the card: NovaProver(rc=100, cuda).prove_from_frames on
    ``frames`` of phase 2's hydrated fib(100), then NovaProver.verify, and
    a proof with one entry of its final W changed; each commit's kernel
    then timed alone; then spartan.compress and verify_compressed (the
    JAX REPL's default-else backend). Returns the fold's K6 figures for
    the kernels line."""
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import nova, spartan
    from lurk_tpu_torch.proof.multiframe import io_chain_checker
    from lurk_tpu_torch.proof.prover import NovaProver
    from lurk_tpu_torch.utils import metrics

    # every commit's key, vector and point, in order: W and T of each
    # step, then the verifier's W and E
    with CommitRecorder() as rec:
        commits = rec.records
        metrics.drain()
        prover = NovaProver(rc=STEP_RC, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        pp, proof = prover.prove_from_frames(store, frames)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        launches = M.launches
        poseidon = (K.launches, K.dense_launches, K.folded_launches)
        n_steps = len(proof.steps)
        check(n_steps == len(frames) // STEP_RC,
              f"{n_steps} folding steps, expected {len(frames) // STEP_RC}")
        check(launches == 2 * n_steps, f"{launches} MSM launches in the "
              f"prove, expected {2 * n_steps} (W and T a step)")
        check(poseidon == (0, 0, 0), f"Poseidon launches {poseidon} in the "
              "prove (the store was hydrated in phase 2)")
        shape = pp.shape
        check([vec.n for _, vec, _ in commits] ==
              [shape.num_aux, shape.num_constraints] * n_steps,
              "the commits are not W and T of each step")
        times = {k: metrics.values(f"nova.{k}") for k in
                 ("witness", "pack", "commit_w", "cross_term", "commit_t",
                  "fold", "shape", "shape_save")}
        table_s = metrics.values("ck.table")
        check(len(times["shape"]) == 1, "the shape was not built (the "
              "parameter cache starts cold)")
        print(f"phase 8.1: NovaProver(rc={STEP_RC}, cuda).prove_from_frames("
              f"fib(100)'s first {len(frames)} frames): {n_steps} steps in "
              f"{t_prove:.1f} s; the shape "
              f"{shape.num_constraints} constraints, {shape.num_aux} aux, "
              f"{shape.num_inputs} inputs, built in {times['shape'][0]:.1f} s "
              f"(step 0's full synthesis and the shape digest) and saved "
              f"in {times['shape_save'][0]:.1f} s; key 2^"
              f"{len(pp.ck.gens).bit_length() - 1}, its table on the card "
              f"{sum(table_s):.1f} s (in step 0's commit of W); {launches} "
              f"MSM launches, no Poseidon launch")

        t0 = time.perf_counter()
        M.launches = 0
        ok = NovaProver.verify(pp, proof)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        verify_launches = M.launches
        check(ok, "NovaProver.verify rejects the fold's proof")
        check(verify_launches == 2, f"{verify_launches} MSM launches in "
              "the verify, expected 2 (W and E)")
        w = proof.final_witness.w
        bad_w = PackedVec(w.arr.copy(), w.n, w.p)
        bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
        bad = nova.FoldingProof(
            proof.steps, nova.RelaxedWitness(bad_w, proof.final_witness.e),
            proof.z0, proof.zi)
        check(not NovaProver.verify(pp, bad),
              "verify accepts a proof whose final W was changed")
    print(f"phase 8.2: NovaProver.verify accepts ({t_verify:.1f} s, "
          f"{verify_launches} MSM launches: W and E) and rejects the proof "
          f"with one entry of its final W changed")

    # each commit's kernel alone (the launch the commit made: its rows)
    t0 = time.perf_counter()
    table = pp.ck.table()
    curve = pp.curve
    k_ms, b_ms = [], []
    for _, vec, point in commits[:2 * n_steps + 2]:
        words = vec.arr.view(np.uint32).reshape(vec.n, 8)
        tab = table.prefix(vec.n)
        wt = words_on(tab, words)
        check(M.to_affine(curve, M.msm_words(tab, wt)) == point,
              "a commit's kernel alone differs from the commit")
        k_ms.append(time_ms(lambda: M.msm_words(tab, wt), W_TIMED))
        b_ms.append(bound.msm(words, tab.n)[0])
    for k in range(n_steps):
        wit = (f"{times['witness'][k - 1]:.3f}" if k else
               "(full synthesis, in the shape)")
        print(f"  step {k}: witness {wit} s, pack "
              f"{times['pack'][k]:.4f} s, commit W {times['commit_w'][k]:.3f}"
              f" s, cross-term {times['cross_term'][k]:.3f} s, commit T "
              f"{times['commit_t'][k]:.3f} s, fold {times['fold'][k]:.3f} s "
              f"(host clock); K6 W {k_ms[2 * k]:.3f} ms (bound "
              f"{b_ms[2 * k]:.3f}), T {k_ms[2 * k + 1]:.3f} ms (bound "
              f"{b_ms[2 * k + 1]:.3f}) (CUDA events, {W_TIMED} launches)")
    print(f"  verify: K6 W {k_ms[-2]:.3f} ms, E {k_ms[-1]:.3f} ms")
    # T of step 0 folds into the zero accumulator
    check(commits[1][2] is None and commits[3][2] is not None,
          "step 0's T is not the identity or step 1's T is")
    ms, bound_ms = sum(k_ms), sum(b_ms)
    print(f"phase 8.3: the fold's {len(k_ms)} commits' kernels {ms:.3f} ms "
          f"in all, bound {bound_ms:.3f} ms ({bound_ms / ms:.1%}) "
          f"({time.perf_counter() - t0:.1f} s)")

    # the JAX REPL's other backend compresses this fold with Spartan
    comp = compression(
        ("8.4", "8.5", "8.6"), "spartan.compress", bound,
        lambda: spartan.compress(pp, proof),
        lambda cp: spartan.verify_compressed(
            pp, cp, io_chain_checker(cp.z0, cp.zi)),
        lambda cp: [("one sumcheck value changed", dataclasses.replace(
            cp, spartan=changed_sumcheck(cp.spartan, pp.shape.p))),
                    ("its last step dropped",
                     dataclasses.replace(cp, steps=cp.steps[:-1]))])
    return {"launches": launches + verify_launches + comp["launches"],
            "ms": ms + comp["ms"], "bound_ms": bound_ms + comp["bound_ms"]}


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    K.launches = M.launches = K.dense_launches = K.folded_launches = 0
    M.launches_by_curve.clear()


class CommitRecorder:
    """While active, records each ``CommitmentKey.commit_async`` (and so
    each ``commit``) as [key, packed vector, point], the point filled in
    when the commit is resolved."""

    def __enter__(self):
        from lurk_tpu_torch.hostlib.r1cs import PackedVec
        from lurk_tpu_torch.proof import nova
        self.records = []
        self.nova = nova
        self.orig = orig = nova.CommitmentKey.commit_async

        def recording(key, vec):
            res = orig(key, vec)
            rec = [key, PackedVec.pack(vec, key.curve.order), None]
            self.records.append(rec)

            def resolve():
                rec[2] = res()
                return rec[2]
            return resolve
        nova.CommitmentKey.commit_async = recording
        return self

    def __exit__(self, *exc):
        self.nova.CommitmentKey.commit_async = self.orig


class WaveRecorder:
    """While active, records the (arity, size) of each batched store
    wave (each one K1 launch on the card)."""

    def __enter__(self):
        from lurk_tpu_torch.poseidon import kernel as K
        from lurk_tpu_torch.store import core
        self.waves = waves = []
        self.core, self.hash_batch = core, core.hash_batch

        def recording(field, arity, pres, device=None):
            waves.append((arity, len(pres)))
            return K.hash_batch(field, arity, pres, device)
        core.hash_batch = recording
        return self

    def __exit__(self, *exc):
        self.core.hash_batch = self.hash_batch


def kernel_alone(bound, recs):
    """Each recorded commit of 64 or more scalars (K6's) through the
    kernel alone, equal to its point, timed (CUDA events) with its
    bound: [(curve name, n, ms, bound ms)]."""
    from lurk_tpu_torch.msm import kernel as M
    out = []
    for key, vec, point in recs:
        if vec.n < 64:
            continue
        words = vec.arr.view(np.uint32).reshape(vec.n, 8)
        tab = key.table().prefix(vec.n)
        wt = words_on(tab, words)
        check(M.to_affine(key.curve, M.msm_words(tab, wt)) == point,
              f"a {key.curve.name} commit's kernel alone differs from the "
              f"commit")
        out.append((key.curve.name, vec.n,
                    time_ms(lambda: M.msm_words(tab, wt), W_TIMED),
                    bound.msm(words, tab.n)[0]))
    return out


def by_class(timed):
    """Timed commits grouped by curve and size class (2^k above n):
    {(curve, k): [count, ms, bound ms]}."""
    groups = {}
    for name, n, ms, b in timed:
        g = groups.setdefault((name, (n - 1).bit_length()), [0, 0.0, 0.0])
        g[0] += 1
        g[1] += ms
        g[2] += b
    return groups


def print_classes(what: str, timed) -> None:
    for (name, k), (count, ms, b) in sorted(by_class(timed).items()):
        print(f"  {what} K6 {name} n <= 2^{k}: {count} launches, "
              f"{ms:.3f} ms, bound {b:.3f} ms ({b / ms:.1%})")


# the phases a cycle prover's step records, under supernova_cycle.* or
# nova_cycle.*
CYCLE_PHASES = ("witness", "synthesize_primary", "pack_w1",
                "commit_w1_dispatch", "cross_term1", "commit_t1",
                "fold_witness1", "synthesize_secondary", "commit_w2",
                "cross_term2", "commit_t2", "fold2")


def cycle_commits(s1, s2, n: int):
    """(curve, width) of a cycle prove's commits in order: W1, T1 and W2
    of each step, T2 of each step's pending instance from step 1 on and
    of finish's."""
    step = [("bn254-g1", s1.num_aux), ("bn254-g1", s1.num_constraints),
            ("grumpkin", s2.num_aux)]
    t2 = [("grumpkin", s2.num_constraints)]
    return step + (t2 + step) * (n - 1) + t2


def print_cycle_steps(times, n: int) -> None:
    """A cycle prover's phase times (host clock), a line a step."""
    for k in range(n):
        sec = ("" if k == 0 else
               f", secondary fold: cross-term "
               f"{times['cross_term2'][k - 1]:.3f}, commit T2 "
               f"{times['commit_t2'][k - 1]:.3f}, fold "
               f"{times['fold2'][k - 1]:.3f}")
        print(f"  step {k} (host clock, s): wait for the witness "
              f"{times['witness'][k]:.3f}, synthesize primary "
              f"{times['synthesize_primary'][k]:.3f}, pack W1 "
              f"{times['pack_w1'][k]:.3f}, commit W1 dispatch "
              f"{times['commit_w1_dispatch'][k]:.3f}, cross-term1 "
              f"{times['cross_term1'][k]:.3f}, commit T1 (and wait "
              f"for W1) {times['commit_t1'][k]:.3f}, fold W1 "
              f"{times['fold_witness1'][k]:.3f}, synthesize secondary "
              f"{times['synthesize_secondary'][k]:.3f}, commit W2 "
              f"{times['commit_w2'][k]:.3f}{sec}")
    print(f"  finish: cross-term2 {times['cross_term2'][-1]:.3f}, commit "
          f"T2 {times['commit_t2'][-1]:.3f}, fold "
          f"{times['fold2'][-1]:.3f} s")


def phase9(bound, store, frames) -> dict:
    """The cycle fold on the card: SuperNovaCycleProver(rc=100, cuda)
    .prove_from_frames on phase 2's hydrated fib(100) (its public
    parameters built first and timed, then dropped from memory, so that
    the prove loads them from the disk cache), its verify, and a proof with one
    entry of its final W1 changed; each commit's kernel timed alone;
    step 0's W2 and step 1's T2 against the plain version."""
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import nova, witness_pool
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc
    from lurk_tpu_torch.utils import metrics

    prover = psc.SuperNovaCycleProver(rc=STEP_RC, device="cuda")
    metrics.drain()
    t0 = time.perf_counter()
    pp = psc.sn_cycle_public_params(store, STEP_RC, *prover.setup_funcs(),
                                    device="cuda")
    t_setup = time.perf_counter() - t0
    s1, s2 = pp.shapes1[0], pp.shape2
    print(f"phase 9.0: the cycle's public parameters at rc={STEP_RC} in "
          f"{t_setup:.1f} s (cold cache: the primary circuit's full "
          f"synthesis, its digest and save; the secondary's; the keys): "
          f"primary {s1.num_constraints} constraints, {s1.num_aux} aux; "
          f"secondary {s2.num_constraints}, {s2.num_aux}; keys BN254 2^"
          f"{len(pp.ck1.gens).bit_length() - 1}, Grumpkin 2^"
          f"{len(pp.ck2.gens).bit_length() - 1}")
    jobs = prover.witness_jobs(store, prover.chunks(store, frames))
    check(witness_pool.uses_pool(prover.check_steps, len(jobs)),
          "the fork pool is off")
    # the timed prove loads its parameters as a new process would: the
    # shapes, generators and SRS from the disk cache, no object in memory
    digest = pp.pp_digest
    del pp
    psc._PP_CACHE.clear()
    hk._SRS_MEM.clear()
    load = []
    build_pp = psc.sn_cycle_public_params

    def timed_pp(*args, **kwargs):
        t = time.perf_counter()
        out = build_pp(*args, **kwargs)
        load.append(time.perf_counter() - t)
        return out

    psc.sn_cycle_public_params = timed_pp
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        try:
            pp, proof = prover.prove_from_frames(store, frames)
        finally:
            psc.sn_cycle_public_params = build_pp
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        poseidon = (K.launches, K.dense_launches, K.folded_launches)
        check(len(load) == 1 and pp.pp_digest == digest,
              "the prove's public parameters differ from the cold build's")
        s1, s2 = pp.shapes1[0], pp.shape2
        check(proof.n == len(frames) // STEP_RC == 8,
              f"{proof.n} folding steps, expected 8")
        check(by == {"bn254-g1": 16, "grumpkin": 16},
              f"MSM launches by curve {by} in the prove, expected 16 + 16 "
              f"(W1 and T1 of 8 steps; W2 of 8, T2 of steps 1-7 and "
              f"finish's)")
        check(poseidon == (0, 0, 0), f"Poseidon launches {poseidon} in the "
              "prove (the store was hydrated in phase 2)")
        check([(key.curve.name, vec.n) for key, vec, _ in rec.records] ==
              cycle_commits(s1, s2, proof.n),
              "the commits are not W1, T1 and W2 of each step and T2 of "
              "the pending instances")
        times = {k: metrics.values(f"supernova_cycle.{k}")
                 for k in CYCLE_PHASES}
        tables = metrics.values("ck.table")
        print(f"phase 9.1: SuperNovaCycleProver(rc={STEP_RC}, cuda)"
              f".prove_from_frames(fib(100)): {proof.n} steps in "
              f"{t_prove:.1f} s (the public parameters loaded from the "
              f"disk cache in {load[0]:.1f} s of it; fork pool of "
              f"{min(8, os.cpu_count() - 1)} workers; the keys' tables built "
              f"on the card in step 0's "
              f"commits: {' + '.join(f'{t:.2f}' for t in tables)} s), MSM "
              f"launches {by}, no Poseidon launch")
        print_cycle_steps(times, proof.n)
        t0 = time.perf_counter()
        witness_pool.step_witness(pp.field1, pp.cfg1s[0].step_fn, *jobs[1])
        t_inline = time.perf_counter() - t0
        print(f"  step 1's witness synthesized inline: {t_inline:.3f} s "
              f"(the pool's waits: {sum(times['witness']):.3f} s in all)")

        reset_counts()
        t0 = time.perf_counter()
        ok = prover.verify(pp, proof)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "SuperNovaCycleProver.verify rejects the fold's proof")
        check(vby == {"bn254-g1": 2, "grumpkin": 2}, f"MSM launches "
              f"{vby} in the verify, expected 2 + 2 (W and E a curve)")
        w = proof.w1s[0].w
        bad_w = PackedVec(w.arr.copy(), w.n, w.p)
        bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
        bad = dataclasses.replace(
            proof, w1s=[nova.RelaxedWitness(bad_w, proof.w1s[0].e)])
        check(not prover.verify(pp, bad),
              "verify accepts a proof whose final W1 was changed")
        records = list(rec.records)
    print(f"phase 9.2: verify accepts ({t_verify:.1f} s, MSM launches "
          f"{vby}) and rejects the proof with one entry of its final W1 "
          f"changed")

    t0 = time.perf_counter()
    timed = kernel_alone(bound, records)
    check(len(timed) == 36, f"{len(timed)} commits timed, expected 36")
    print_classes("prove", timed[:32])
    print_classes("verify", timed[32:])
    plain_ms = 0.0
    for k, what in ((2, "step 0's W2"), (3, "step 1's T2")):
        key, vec, point = records[k]
        words = vec.arr.view(np.uint32).reshape(vec.n, 8)
        plain, ms = plain_commit(key.curve, key.table(), words)
        plain_ms += ms
        check(plain == point, f"{what} commit differs from the plain version")
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 9.3: the cycle fold's {len(timed)} commits' kernels "
          f"{ms:.3f} ms in all, bound {bound_ms:.3f} ms "
          f"({bound_ms / ms:.1%}); step 0's W2 and step 1's T2 "
          f"equal the plain version on the card ({plain_ms:.1f} ms, host "
          f"clock) ({time.perf_counter() - t0:.1f} s)")
    return {"launches": 36, "ms": ms, "bound_ms": bound_ms,
            "plain_ms": plain_ms, "pp": pp, "proof": proof,
            "t_prove": t_prove, "t_setup": t_setup}


SPARTAN_PHASES = ("matvecs", "sumcheck1", "mvec", "sumcheck2", "kzg_open",
                  "ipa_open")


def compression(labels, name: str, bound, compress, verify, bads) -> dict:
    """A compression on the card: ``compress()`` (HyperKZG's commits
    through K6 on BN254, the IPA's MSMs on the host), ``verify(cp)``
    accepting with no MSM launch and rejecting each of ``bads(cp)``
    (what, changed proof); HyperKZG's K6 commits then timed alone with
    their bounds. Prints under the three phase ``labels``."""
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.utils import metrics

    metrics.drain()
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        cp = compress()
        torch.cuda.synchronize()
        t_compress = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        records = list(rec.records)
    big = [r for r in records if r[1].n >= 64]
    check(set(by) == {"bn254-g1"} and by["bn254-g1"] == len(big),
          f"MSM launches {by} in the compress, expected one a HyperKZG "
          f"commit of 64 or more scalars ({len(big)}) and none on Grumpkin")
    spans = {k: metrics.values(f"spartan.{k}") for k in SPARTAN_PHASES}
    print(f"phase {labels[0]}: {name} {t_compress:.1f} s; spartan "
          + ", ".join(f"{k} " + "+".join(f"{v:.2f}" for v in vals)
                      for k, vals in spans.items() if vals)
          + f" s (one value a side, in the order they ended); {len(records)} "
          f"HyperKZG commits, {len(big)} through K6")

    reset_counts()
    t0 = time.perf_counter()
    ok = verify(cp)
    t_verify = time.perf_counter() - t0
    check(ok, f"the verifier rejects {name}'s proof")
    check(M.launches == 0, f"{M.launches} MSM launches in the verify")
    rejected = []
    for what, bad in bads(cp):
        check(not verify(bad), f"the verifier accepts a compressed proof "
              f"with {what}")
        rejected.append(what)
    print(f"phase {labels[1]}: the verifier accepts ({t_verify:.1f} s, no "
          f"MSM launch) and rejects the proof with "
          + " and with ".join(rejected))
    t0 = time.perf_counter()
    timed = kernel_alone(bound, big)
    print_classes("compress", timed)
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase {labels[2]}: the compress's {len(timed)} K6 commits "
          f"{ms:.3f} ms in all, bound {bound_ms:.3f} ms ({bound_ms / ms:.1%})"
          f" ({time.perf_counter() - t0:.1f} s)")
    return {"launches": len(timed), "ms": ms, "bound_ms": bound_ms,
            "t_compress": t_compress, "t_verify": t_verify, "cp": cp,
            "records": big}


def changed_sumcheck(sp, p: int):
    """Spartan proof ``sp`` with one value of its first sumcheck
    changed."""
    polys = [list(r) for r in sp.sc1_polys]
    polys[3][1] = (polys[3][1] + 1) % p
    return dataclasses.replace(sp, sc1_polys=polys)


def phase10(bound, pp, proof) -> dict:
    """Compression on the card: compress_sn_cycle (HyperKZG's commits
    through K6, the IPA's on the host), verify_compressed_sn_cycle, and
    a compressed proof with one sumcheck value changed."""
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc

    return compression(
        ("10.1", "10.2", "10.3"), "compress_sn_cycle", bound,
        lambda: psc.compress_sn_cycle(pp, proof),
        lambda cp: psc.verify_compressed_sn_cycle(pp, cp),
        lambda cp: [("one sumcheck value changed", dataclasses.replace(
            cp, spartans1=[changed_sumcheck(cp.spartans1[0],
                                            pp.field1.modulus)]))])


def phase11(bound, store, frames) -> dict:
    """The Nova cycle on the card (the JAX REPL's ``nova`` backend):
    cycle_public_params built and timed, CycleNovaProver(rc=100, cuda)
    .prove_from_frames on phase 2's hydrated fib(100) with the objects
    of the build, verify and a proof with one entry of its final W1
    changed, compress_cycle and verify_compressed_cycle with a changed
    sumcheck value; each commit's kernel timed alone, one Grumpkin W2
    commit against the plain version."""
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import nova, witness_pool
    from lurk_tpu_torch.proof import prover_cycle as pcy
    from lurk_tpu_torch.proof.multiframe import MultiFrame
    from lurk_tpu_torch.utils import metrics

    prover = pcy.CycleNovaProver(rc=STEP_RC, device="cuda")
    step = prover.step_func()
    metrics.drain()
    t0 = time.perf_counter()
    pp = pcy.cycle_public_params(store, STEP_RC, step, device="cuda")
    t_setup = time.perf_counter() - t0
    s1, s2 = pp.shape1, pp.shape2
    print(f"phase 11.0: the Nova cycle's public parameters at rc={STEP_RC} "
          f"in {t_setup:.1f} s (cold cache: the primary augmented "
          f"circuit's full synthesis, its digest and save; the "
          f"secondary's; the keys): primary {s1.num_constraints} "
          f"constraints, {s1.num_aux} aux; secondary {s2.num_constraints}, "
          f"{s2.num_aux}; keys BN254 2^{len(pp.ck1.gens).bit_length() - 1}, "
          f"Grumpkin 2^{len(pp.ck2.gens).bit_length() - 1}")
    mframes = MultiFrame.from_frames(frames, STEP_RC, step, store)
    check(witness_pool.uses_pool(prover.check_steps, len(mframes)),
          "the fork pool is off")
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        pp2, proof = prover.prove_from_frames(store, frames)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        poseidon = (K.launches, K.dense_launches, K.folded_launches)
        check(pp2 is pp, "the prove built other public parameters")
        n = PHASE11_FRAMES // STEP_RC
        check(proof.n == len(frames) // STEP_RC == n,
              f"{proof.n} folding steps, expected {n}")
        check(by == {"bn254-g1": 2 * n, "grumpkin": 2 * n},
              f"MSM launches by curve {by} in the prove, expected {2 * n} "
              f"+ {2 * n} (W1 and T1 of {n} steps; W2 of {n}, T2 of steps "
              f"1-{n - 1} and finish's)")
        check(poseidon == (0, 0, 0), f"Poseidon launches {poseidon} in the "
              "prove (the store was hydrated in phase 2)")
        check([(key.curve.name, vec.n) for key, vec, _ in rec.records] ==
              cycle_commits(s1, s2, proof.n),
              "the commits are not W1, T1 and W2 of each step and T2 of "
              "the pending instances")
        times = {k: metrics.values(f"nova_cycle.{k}") for k in CYCLE_PHASES}
        tables = metrics.values("ck.table")
        print(f"phase 11.1: CycleNovaProver(rc={STEP_RC}, cuda)"
              f".prove_from_frames(fib(100)'s first {len(frames)} frames): "
              f"{proof.n} steps in "
              f"{t_prove:.1f} s (the public parameters of 11.0 reused; "
              f"fork pool of {min(8, os.cpu_count() - 1)} workers; the "
              f"keys' tables built on the card in step 0's commits: "
              f"{' + '.join(f'{t:.2f}' for t in tables)} s), MSM launches "
              f"{by}, no Poseidon launch")
        print_cycle_steps(times, proof.n)
        print(f"  the pool's waits: {sum(times['witness']):.3f} s in all")

        reset_counts()
        t0 = time.perf_counter()
        ok = prover.verify(pp, proof)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "CycleNovaProver.verify rejects the fold's proof")
        check(vby == {"bn254-g1": 2, "grumpkin": 2}, f"MSM launches "
              f"{vby} in the verify, expected 2 + 2 (W and E a curve)")
        w = proof.w1.w
        bad_w = PackedVec(w.arr.copy(), w.n, w.p)
        bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
        bad = dataclasses.replace(
            proof, w1=nova.RelaxedWitness(bad_w, proof.w1.e))
        check(not prover.verify(pp, bad),
              "verify accepts a proof whose final W1 was changed")
        records = list(rec.records)
    print(f"phase 11.2: verify accepts ({t_verify:.1f} s, MSM launches "
          f"{vby}) and rejects the proof with one entry of its final W1 "
          f"changed")

    t0 = time.perf_counter()
    timed = kernel_alone(bound, records)
    check(len(timed) == 4 * n + 4, f"{len(timed)} commits timed, expected "
          f"{4 * n + 4}")
    print_classes("prove", timed[:4 * n])
    print_classes("verify", timed[4 * n:])
    key, vec, point = records[2]
    plain, plain_ms = plain_commit(
        key.curve, key.table(), vec.arr.view(np.uint32).reshape(vec.n, 8))
    check(plain == point, "step 0's W2 commit differs from the plain version")
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 11.3: the Nova cycle's {len(timed)} commits' kernels "
          f"{ms:.3f} ms in all, bound {bound_ms:.3f} ms "
          f"({bound_ms / ms:.1%}); step 0's W2 ({vec.n} scalars, Grumpkin) "
          f"equals the plain version on the card ({plain_ms:.1f} ms, host "
          f"clock) ({time.perf_counter() - t0:.1f} s)")

    comp = compression(
        ("11.4", "11.5", "11.6"), "compress_cycle", bound,
        lambda: pcy.compress_cycle(pp, proof),
        lambda cp: pcy.verify_compressed_cycle(pp, cp),
        lambda cp: [("one sumcheck value changed", dataclasses.replace(
            cp, spartan1=changed_sumcheck(cp.spartan1, pp.field1.modulus)))])
    return {"launches": 36 + comp["launches"], "ms": ms + comp["ms"],
            "bound_ms": bound_ms + comp["bound_ms"], "plain_ms": plain_ms,
            "t_setup": t_setup, "t_prove": t_prove,
            "t_compress": comp["t_compress"],
            "t_verify": comp["t_verify"]}


def phase12(bound, store, frames) -> dict:
    """NIVC on the card (the JAX REPL's ``supernova`` backend):
    SuperNovaProver(rc=100, Lang(), cuda).prove_from_frames on
    ``frames`` (the first PHASE12_FRAMES of phase 2's hydrated fib(100)),
    its ``-nivc`` shape built and saved in the prove;
    verify and a proof with one final witness entry changed; compress
    and verify_compressed with a changed step input and with no Spartan
    proofs; each commit's kernel timed alone, one HyperKZG chain commit
    of 2^12 scalars or fewer against the plain version."""
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.lem.evaluation import Lang
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import nova
    from lurk_tpu_torch.proof import supernova as sn
    from lurk_tpu_torch.utils import metrics

    prover = sn.SuperNovaProver(rc=STEP_RC, lang=Lang(), device="cuda")
    metrics.drain()
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        pp, proof = prover.prove_from_frames(store, frames)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        poseidon = (K.launches, K.dense_launches, K.folded_launches)
        n_steps = len(proof.steps)
        shape = pp.shapes[0]
        check(n_steps == len(frames) // STEP_RC == PHASE12_FRAMES // STEP_RC,
              f"{n_steps} folding steps, expected "
              f"{PHASE12_FRAMES // STEP_RC}")
        check(by == {"bn254-g1": 2 * n_steps}, f"MSM launches {by} in the "
              f"prove, expected {2 * n_steps} on BN254 (W and T a step)")
        check(poseidon == (0, 0, 0), f"Poseidon launches {poseidon} in the "
              "prove (the store was hydrated in phase 2)")
        check([vec.n for _, vec, _ in rec.records] ==
              [shape.num_aux, shape.num_constraints] * n_steps,
              "the commits are not W and T of each step")
        times = {k: metrics.values(k) for k in
                 ("supernova.shape", "supernova.shape_save",
                  "supernova.witness", "nova.pack", "nova.commit_w",
                  "nova.cross_term", "nova.commit_t", "nova.fold",
                  "ck.table")}
        check(len(times["supernova.shape"]) == 1, "the -nivc shape was not "
              "built (the parameter cache starts cold)")
        print(f"phase 12.1: SuperNovaProver(rc={STEP_RC}, Lang(), cuda)"
              f".prove_from_frames(fib(100)'s first {len(frames)} frames):"
              f" {n_steps} steps in "
              f"{t_prove:.1f} s; the -nivc shape {shape.num_constraints} "
              f"constraints, {shape.num_aux} aux, built in "
              f"{times['supernova.shape'][0]:.1f} s (step 0's full "
              f"synthesis and the digest) and saved in "
              f"{times['supernova.shape_save'][0]:.1f} s; key 2^"
              f"{len(pp.ck.gens).bit_length() - 1}, its table on the card "
              f"{sum(times['ck.table']):.1f} s (in step 0's commit of W); "
              f"MSM launches {by}, no Poseidon launch")
        for k in range(n_steps):
            wit = (f"{times['supernova.witness'][k - 1]:.3f}" if k else
                   "(full synthesis, in the shape)")
            print(f"  step {k} (host clock, s): witness inline {wit}, pack "
                  f"{times['nova.pack'][k]:.4f}, commit W "
                  f"{times['nova.commit_w'][k]:.3f}, cross-term "
                  f"{times['nova.cross_term'][k]:.3f}, commit T "
                  f"{times['nova.commit_t'][k]:.3f}, fold "
                  f"{times['nova.fold'][k]:.3f}")

        reset_counts()
        t0 = time.perf_counter()
        ok = sn.verify(pp, proof)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "supernova.verify rejects the NIVC proof")
        check(vby == {"bn254-g1": 2}, f"MSM launches {vby} in the verify, "
              f"expected 2 (W and E of the one circuit)")
        wit = proof.final_witnesses[0]
        bad_w = PackedVec(wit.w.arr.copy(), wit.w.n, wit.w.p)
        bad_w[wit.w.n // 2] = (bad_w[wit.w.n // 2] + 1) % wit.w.p
        bad = dataclasses.replace(
            proof, final_witnesses={0: nova.RelaxedWitness(bad_w, wit.e)})
        check(not sn.verify(pp, bad),
              "verify accepts a proof whose final witness was changed")
        records = list(rec.records)
    print(f"phase 12.2: verify accepts ({t_verify:.1f} s, MSM launches "
          f"{vby}) and rejects the proof with one final witness entry "
          f"changed")
    t0 = time.perf_counter()
    timed = kernel_alone(bound, records)
    check(len(timed) == 2 * n_steps + 2,
          f"{len(timed)} commits timed, expected {2 * n_steps + 2}")
    print_classes("prove", timed[:2 * n_steps])
    print_classes("verify", timed[2 * n_steps:])
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 12.3: NIVC's {len(timed)} commits' kernels {ms:.3f} ms in "
          f"all, bound {bound_ms:.3f} ms ({bound_ms / ms:.1%}) "
          f"({time.perf_counter() - t0:.1f} s)")

    def bads(cp):
        pc, inst, comm_t = cp.steps[0]
        x = list(inst.x)
        x[0] = (x[0] + 1) % shape.p
        steps = [(pc, nova.R1CSInstance(inst.comm_w, x), comm_t)]
        return [("a changed step input",
                 dataclasses.replace(cp, steps=steps + cp.steps[1:])),
                ("no Spartan proofs", dataclasses.replace(cp, spartans={}))]

    comp = compression(("12.4", "12.5", "12.6"), "supernova.compress", bound,
                       lambda: sn.compress(pp, proof),
                       lambda cp: sn.verify_compressed(pp, cp), bads)
    key, vec, point = max((r for r in comp["records"] if r[1].n <= 1 << 12),
                          key=lambda r: r[1].n)
    plain, plain_ms = plain_commit(
        key.curve, key.table(), vec.arr.view(np.uint32).reshape(vec.n, 8))
    check(plain == point, "a HyperKZG chain commit differs from the plain "
          "version")
    print(f"phase 12.7: the HyperKZG chain commit of {vec.n} scalars equals "
          f"the plain version on the card ({plain_ms:.1f} ms, host clock)")
    return {"launches": len(timed) + comp["launches"],
            "ms": ms + comp["ms"], "bound_ms": bound_ms + comp["bound_ms"],
            "plain_ms": plain_ms, "t_prove": t_prove,
            "t_compress": comp["t_compress"],
            "t_verify": comp["t_verify"]}


# phase 13's parts, each with the range PERF.md section 5 predicted
# before its first run on the card
CLI_PREDICTED = {"load --prove": "45-60", "verify (new process)": "15-25",
                 "inspect": "< 5", "verify (changed proof)": "< 5"}


def phase13(bound, cp) -> dict:
    """The CLI on the card: ``load <fib(100)> --rc 100 --limit 800
    --prove`` through ``lurk_tpu_torch.cli.__main__.main`` in this
    process, with the default device and backend (supernova-cycle,
    compressed, self-checked), its public parameters dropped from
    memory first so that they load from the disk cache as in a new
    process; 800 iterations, K1 and K6 launched, the persisted proof
    equal to phase 10's compressed proof ``cp``; then ``python -m
    lurk_tpu_torch.cli verify`` in a child process, ``inspect``, and
    ``verify`` of a copy with one sumcheck value changed (rejected).
    The CLI's K1 waves and K6 commits are then timed alone."""
    from lurk_tpu_torch.cli.__main__ import main as cli_main
    from lurk_tpu_torch.cli.lurk_proof import (
        LurkProof, LurkProofMeta, proofs_dir)
    from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc

    root = Path(__file__).resolve().parent
    src = root / "lurk_tpu_torch" / "_build" / "fib100.lurk"
    src.write_text(FIB_PROGRAM)
    psc._PP_CACHE.clear()
    hk._SRS_MEM.clear()
    times = {}
    out = io.StringIO()
    with WaveRecorder() as wrec, CommitRecorder() as rec, \
            contextlib.redirect_stdout(out):
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(["load", str(src), "--rc", str(STEP_RC),
                       "--limit", str(fib_limit(100, STEP_RC)), "--prove"])
        torch.cuda.synchronize()
        times["load --prove"] = time.perf_counter() - t0
        k1, k6 = K.launches, dict(M.launches_by_curve)
        commits = list(rec.records)
    waves = wrec.waves
    print(out.getvalue(), end="")
    check(rc == 0, f"the CLI's load --prove returned {rc}")
    m = re.search(r'Proof key: "([^"]+)"', out.getvalue())
    check(m is not None, "the CLI printed no proof key")
    key = m.group(1)
    check(key.startswith(f"supernova-cycle_bn256_{STEP_RC}_"),
          f"proof key {key}")
    meta = LurkProofMeta.load(key)
    check(meta is not None and meta.iterations == 800,
          "the CLI's evaluation is not phase 2's 800 frames")
    check(k1 == len(waves) > 0, f"{k1} K1 launches for the CLI's "
          f"{len(waves)} batched waves")
    check(set(k6) == {"bn254-g1", "grumpkin"},
          f"K6 launches {k6} in the CLI's prove")
    path = proofs_dir() / f"{key}.proof.json"
    text = path.read_text()
    check(text == LurkProof(cp, STEP_RC, "bn256", "supernova-cycle",
                            "compressed").to_json(),
          "the CLI's proof file differs from phase 10's compressed proof")
    print(f"phase 13.1: python -m lurk_tpu_torch.cli load fib100.lurk "
          f"--rc {STEP_RC} --limit {fib_limit(100, STEP_RC)} --prove "
          f"(in-process, default device and backend): 800 iterations, "
          f"K1 {k1} launches (waves {waves}), K6 {k6}; the proof file "
          f"({len(text):,} bytes) equals phase 10's compressed proof")

    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "lurk_tpu_torch.cli", "verify", key,
         "--rc", str(STEP_RC)], capture_output=True, text=True,
        cwd=root, timeout=600)
    times["verify (new process)"] = time.perf_counter() - t0
    check(child.returncode == 0 and "Proof verified" in child.stdout,
          f"the child's verify: exit {child.returncode}, stdout "
          f"{child.stdout[-500:]!r}, stderr {child.stderr[-2000:]!r}")

    t0 = time.perf_counter()
    check(cli_main(["inspect", key]) == 0, "inspect failed")
    times["inspect"] = time.perf_counter() - t0

    d = json.loads(text)
    row = d["proof"]["spartans1"][0]["sc1"][3]
    row[1] = f"{(int(row[1], 16) + 1) % BN256_SCALAR.modulus:x}"
    bad_key = key + "-changed"
    path.with_name(f"{bad_key}.proof.json").write_text(json.dumps(d))
    t0 = time.perf_counter()
    check(cli_main(["verify", bad_key, "--rc", str(STEP_RC)]) == 1,
          "verify accepts the proof with one sumcheck value changed")
    times["verify (changed proof)"] = time.perf_counter() - t0
    print("phase 13.2: python -m lurk_tpu_torch.cli verify in a new "
          "process exits 0 (\"Proof verified\"); inspect; the copy with "
          "one sumcheck value changed is rejected (exit 1); seconds: "
          + ", ".join(f"{k} {v:.1f} (predicted {CLI_PREDICTED[k]})"
                      for k, v in times.items()))

    dev = torch.device("cuda")
    const_bytes = {a: K.constants(BN256_SCALAR, a, dev).numel() * 4
                   for a in {a for a, _ in waves}}
    k1_ms = k1_bound = 0.0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    for arity, b in waves:
        x = random_preimages(BN256_SCALAR, arity, b, gen, dev)
        k1_ms += time_ms(lambda: K.poseidon_hash(BN256_SCALAR, arity, x),
                         20)
        k1_bound += bound.of(BN256_SCALAR, arity, b, const_bytes[arity])[0]
    timed = kernel_alone(bound, commits)
    check(len(timed) == sum(k6.values()),
          f"{len(timed)} commits timed, {k6} launched")
    print_classes("CLI", timed)
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 13.3: the CLI's {k1} K1 waves {k1_ms:.4f} ms (bound "
          f"{k1_bound:.6f} ms), its {len(timed)} K6 commits {ms:.3f} ms "
          f"(bound {bound_ms:.3f} ms, {bound_ms / ms:.1%}), each timed "
          f"alone")
    return {"k1": {"launches": k1, "ms": k1_ms, "bound_ms": k1_bound},
            "k6": {"launches": len(timed), "ms": ms, "bound_ms": bound_ms},
            "times": times}


# phase 14's sha256 NIVC proof (BASELINE.md's config 5), each part with
# the range PERF.md section 5 predicted before its first run on the card
SHA256_RC = 10
SHA256_PREDICTED = {"public parameters": "15-30", "prove": "3-8",
                    "compress": "9-11", "verify": "3-4"}


def phase14(bound, gen, dev) -> dict:
    """Coprocessors on the card. 14.1: the trie program read and
    evaluated on a Store(BN256, cuda) (its result checked), hydrated
    through K1 (a launch a batched wave, every digest against host
    hashing) and each wave's kernel timed alone. 14.2: the sha256 NIVC
    program ``(sha256_nivc_1 1)`` through SuperNovaCycleProver(rc=10,
    cuda): the public parameters cold and timed (two primary circuits,
    keys BN254 2^18 and Grumpkin 2^15),
    3 steps through the fork pool, K6 launches by curve, the sha256
    step's W1 against the plain version, verify and a changed final W1,
    compress_sn_cycle and its verifier with a changed sumcheck value.
    14.3: the same program through SuperNovaProver(rc=10) as
    scripts/torch_sha256_nivc.py proves it, then compress and
    verify_compressed."""
    from lurk_tpu_torch.coproc.sha256 import (
        sha256_coprocessor, sha256_nivc_symbol)
    from lurk_tpu_torch.coproc.trie import install_trie_lang
    from lurk_tpu_torch.examples import TRIE_PROGRAM, TRIE_RESULT
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.lem.evaluation import Lang, LangSetup, evaluate
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.parser import read_with_default_state
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import nova, witness_pool
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc
    from lurk_tpu_torch.proof import supernova as sn
    from lurk_tpu_torch.store.core import Store
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from torch_sha256_nivc import prove_sha256_nivc

    # ---- 14.1: the trie program, hydrated through K1 ----
    t0 = time.perf_counter()
    lang, *_ = install_trie_lang()
    store = Store(BN256_SCALAR, device=dev)
    frames = evaluate(LangSetup.nivc(lang),
                      read_with_default_state(store, TRIE_PROGRAM), store,
                      1_000_000)
    t_eval = time.perf_counter() - t0
    check(len(frames) == 1590 and sum(f.pc != 0 for f in frames) == 5,
          f"{len(frames)} frames, {sum(f.pc != 0 for f in frames)} of "
          f"them coprocessor frames; expected 1590 and 5")
    check(store.fetch_num(frames[-1].output[0]) == TRIE_RESULT,
          "the trie program's result is not the reference's")
    reset_counts()
    with WaveRecorder() as rec:
        t0 = time.perf_counter()
        store.hydrate_z_cache()
        torch.cuda.synchronize()
        t_hyd = time.perf_counter() - t0
        launches = K.launches
    big = rec.waves
    check(launches == len(big) and launches > 0,
          f"{launches} K1 launches for {len(big)} batched waves")
    host = Store(BN256_SCALAR, device="cpu")
    host_frames = evaluate(LangSetup.nivc(lang), read_with_default_state(
        host, TRIE_PROGRAM), host, 1_000_000)
    for iv, d in store.z_cache.items():
        check(host.hash_ptr_val(iv) == d, f"hydrated digest of {iv} differs")
    for f, g in zip(frames, host_frames):
        check([store.hash_ptr(p) for p in f.input + f.output]
              == [host.hash_ptr(p) for p in g.input + g.output],
              "the trie program's z-ptrs differ from host hashing")
    print(f"phase 14.1: the trie program {len(frames)} frames (5 "
          f"coprocessor frames), result {TRIE_RESULT}; evaluate "
          f"{t_eval:.2f} s, hydrate {t_hyd:.3f} s: {len(big)} batched "
          f"waves {big}, {launches} K1 launches; {len(store.z_cache)} "
          f"digests equal host hashing")
    k1_ms, k1_plain, k1_bound, k1_err, _ = waves_alone(bound, gen, dev, big)
    k1 = {"launches": launches, "ms": k1_ms, "plain_ms": k1_plain,
          "bound_ms": k1_bound, "max_abs_err": k1_err}
    trie = (store, lang, frames)        # phase 18 proves it

    # ---- 14.2: the sha256 NIVC program through the SuperNova cycle ----
    # the keys as a new process sizes them (the SRS from the disk cache
    # at the length the circuits need), not the 2^21 SRS that phases
    # 9-13 left in memory, whose table on the card would take 6-7 s
    hk._SRS_MEM.clear()
    lang = Lang()
    sym = sha256_nivc_symbol(1)
    lang.add_coprocessor(sym, sha256_coprocessor(1))
    store = Store(BN256_SCALAR, device=dev)
    frames = evaluate(LangSetup.nivc(lang), store.list(
        [store.intern_symbol(sym), store.num(1)]), store, 100)
    check([f.pc for f in frames] == [0, 0, 1, 0],
          f"pcs {[f.pc for f in frames]}, expected [0, 0, 1, 0]")
    store.hydrate_z_cache()
    prover = psc.SuperNovaCycleProver(rc=SHA256_RC, lang=lang, device=dev)
    times = {}
    t0 = time.perf_counter()
    pp = psc.sn_cycle_public_params(store, SHA256_RC, *prover.setup_funcs(),
                                    lang, device=dev)
    times["public parameters"] = time.perf_counter() - t0
    s1s, s2 = pp.shapes1, pp.shape2
    # the augmented pc-0 circuit (the rc = 10 step and the fold's
    # gadgets) is above 2^17 constraints
    check(pp.n_circuits == 2 and len(pp.ck1.gens) == 1 << 18 and
          len(pp.ck2.gens) == 1 << 15,
          f"{pp.n_circuits} primary circuits, keys {len(pp.ck1.gens)} and "
          f"{len(pp.ck2.gens)}; expected 2, 2^18 and 2^15")
    print(f"phase 14.2: sn_cycle_public_params(rc={SHA256_RC}, sha256 Lang, "
          f"cuda) cold in {times['public parameters']:.1f} s: primary "
          + ", ".join(f"pc {pc} {s.num_constraints} constraints, "
                      f"{s.num_aux} aux" for pc, s in enumerate(s1s))
          + f"; secondary {s2.num_constraints}, {s2.num_aux}; keys BN254 "
          f"2^{len(pp.ck1.gens).bit_length() - 1}, Grumpkin 2^15")
    jobs = prover.witness_jobs(store, prover.chunks(store, frames))
    check(witness_pool.uses_pool(prover.check_steps, len(jobs)),
          "the fork pool is off")
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        pp, proof = prover.prove_from_frames(store, frames)
        torch.cuda.synchronize()
        times["prove"] = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        check(proof.n == 3, f"{proof.n} folding steps, expected 3")
        check(by == {"bn254-g1": 6, "grumpkin": 6},
              f"MSM launches by curve {by} in the prove, expected 6 + 6 "
              f"(W1 and T1 of 3 steps; W2 of 3, T2 of steps 1-2 and "
              f"finish's)")
        check(K.launches == 0, f"{K.launches} K1 launches in the prove (the "
              f"store was hydrated)")
        # step 1 runs the sha256 circuit: its W1 is the fifth commit
        key, vec, point = rec.records[4]
        check(key.curve.name == "bn254-g1" and vec.n == s1s[1].num_aux,
              "the fifth commit is not the sha256 step's W1")
        print(f"phase 14.2: SuperNovaCycleProver(rc={SHA256_RC}, sha256 "
              f"Lang, cuda).prove_from_frames: {proof.n} steps (pcs "
              f"{[c[0].pc for c in prover.chunks(store, frames)]}, fork "
              f"pool) in {times['prove']:.1f} s, MSM launches {by}")
        reset_counts()
        t0 = time.perf_counter()
        ok = prover.verify(pp, proof)
        torch.cuda.synchronize()
        t_verify = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "SuperNovaCycleProver.verify rejects the sha256 proof")
        check(vby == {"bn254-g1": 4, "grumpkin": 2}, f"MSM launches {vby} "
              f"in the verify, expected 4 + 2 (W and E a circuit)")
        records = list(rec.records)
    w = proof.w1s[1].w
    bad_w = PackedVec(w.arr.copy(), w.n, w.p)
    bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
    w1s = list(proof.w1s)
    w1s[1] = nova.RelaxedWitness(bad_w, proof.w1s[1].e)
    check(not prover.verify(pp, dataclasses.replace(proof, w1s=w1s)),
          "verify accepts a proof whose final W1 was changed")
    words = vec.arr.view(np.uint32).reshape(vec.n, 8)
    plain, plain_ms = plain_commit(key.curve, key.table(), words)
    check(plain == point, "the sha256 step's W1 commit differs from the "
          "plain version")
    timed = kernel_alone(bound, records)
    check(len(timed) == 18, f"{len(timed)} commits timed, expected 18")
    print_classes("prove", timed[:12])
    print_classes("verify", timed[12:])
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 14.2: verify accepts ({t_verify:.1f} s, MSM launches "
          f"{vby}) and rejects a changed final W1 of the sha256 circuit; "
          f"the sha256 step's W1 ({vec.n} scalars) equals the plain "
          f"version on the card ({plain_ms:.1f} ms, host clock); the "
          f"{len(timed)} commits' kernels {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_ms / ms:.1%})")
    comp = compression(
        ("14.2", "14.2", "14.2"), "compress_sn_cycle", bound,
        lambda: psc.compress_sn_cycle(pp, proof),
        lambda cp: psc.verify_compressed_sn_cycle(pp, cp),
        lambda cp: [("one sumcheck value changed", dataclasses.replace(
            cp, spartans1=[changed_sumcheck(cp.spartans1[0],
                                            pp.field1.modulus),
                           cp.spartans1[1]]))])
    times["compress"], times["verify"] = comp["t_compress"], comp["t_verify"]
    print("phase 14.2: the sha256 NIVC proof through the SuperNova cycle, "
          "seconds (host clock): "
          + ", ".join(f"{k} {v:.1f} (predicted {SHA256_PREDICTED[k]})"
                      for k, v in times.items()))

    # ---- 14.3: the same program through NIVC (SuperNovaProver) ----
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        _, npp, nproof, nframes, _ = prove_sha256_nivc(1, dev, SHA256_RC)
        torch.cuda.synchronize()
        t_nivc = time.perf_counter() - t0
        nby = dict(M.launches_by_curve)
        pcs = [pc for pc, _, _ in nproof.steps]
        check(len(nframes) == 4 and pcs == [0, 1, 0],
              f"{len(nframes)} frames, steps of circuits {pcs}; expected 4 "
              f"and [0, 1, 0]")
        check(nby == {"bn254-g1": 10}, f"MSM launches {nby} in the prove "
              f"and verify, expected 10 on BN254 (W and T of 3 steps, W "
              f"and E of 2 circuits)")
        nrecords = list(rec.records)
    ntimed = kernel_alone(bound, nrecords)
    check(len(ntimed) == 10, f"{len(ntimed)} commits timed, expected 10")
    print_classes("prove and verify", ntimed)
    nms, nbound = sum(t[2] for t in ntimed), sum(t[3] for t in ntimed)
    print(f"phase 14.3: scripts/torch_sha256_nivc.py's prove_sha256_nivc "
          f"(SuperNovaProver(rc={SHA256_RC}), then verify): {len(nframes)} "
          f"frames, {len(pcs)} steps over circuits {sorted(set(pcs))}, "
          f"{t_nivc:.1f} s; MSM launches {nby}; kernels {nms:.3f} ms, "
          f"bound {nbound:.3f} ms ({nbound / nms:.1%})")

    def bads(cp):
        pc, inst, comm_t = cp.steps[1]
        x = list(inst.x)
        x[0] = (x[0] + 1) % BN256_SCALAR.modulus
        steps = list(cp.steps)
        steps[1] = (pc, nova.R1CSInstance(inst.comm_w, x), comm_t)
        return [("a changed input of the sha256 step",
                 dataclasses.replace(cp, steps=steps))]

    ncomp = compression(("14.3", "14.3", "14.3"), "supernova.compress",
                        bound, lambda: sn.compress(npp, nproof),
                        lambda cp: sn.verify_compressed(npp, cp), bads)
    check(sorted(ncomp["cp"].spartans) == [0, 1],
          "the compressed NIVC proof lacks a circuit's Spartan proof")
    return {"k1": k1, "trie": trie,
            "k6": {"launches": len(timed) + comp["launches"] + len(ntimed)
                   + ncomp["launches"],
                   "ms": ms + comp["ms"] + nms + ncomp["ms"],
                   "bound_ms": bound_ms + comp["bound_ms"] + nbound
                   + ncomp["bound_ms"], "plain_ms": plain_ms},
            "times": times, "t_nivc": t_nivc,
            "t_nivc_compress": ncomp["t_compress"],
            "t_nivc_verify": ncomp["t_verify"]}


# phase 15's circom gadget, each part with the range PERF.md section 5
# predicted before its first run on the card
CIRCOM_ROWS = 1 << 14           # x_{i+1} = x_i * x_i
CIRCOM_REF = "lurk-port/square_chain"
CIRCOM_RC = 10
CIRCOM_PREDICTED = {"shapes": "2-5", "prove": "5-10", "verify": "0.5-1.5",
                    "compress": "2-5", "verify_compressed": "1-2"}


def write_r1cs(path: Path, prime: int, constraints, n_wires: int,
               n_pub_out: int, n_pub_in: int) -> None:
    """An iden3 ``.r1cs`` file (version 1: the header section, then the
    constraints section; labels are not written) with 32-byte field
    elements."""
    import struct
    fs = 32

    def lc_bytes(lc):
        return struct.pack("<I", len(lc)) + b"".join(
            struct.pack("<I", w) + (c % prime).to_bytes(fs, "little")
            for w, c in lc.items())

    header = struct.pack("<I", fs) + prime.to_bytes(fs, "little") + \
        struct.pack("<IIIIQI", n_wires, n_pub_out, n_pub_in, 0, n_wires,
                    len(constraints))
    body = b"".join(lc_bytes(a) + lc_bytes(b) + lc_bytes(c)
                    for a, b, c in constraints)
    path.write_bytes(b"r1cs" + struct.pack("<II", 1, 2)
                     + struct.pack("<IQ", 1, len(header)) + header
                     + struct.pack("<IQ", 2, len(body)) + body)


def write_square_chain(folder: Path, rows: int, x: int, prime: int) -> int:
    """``square_chain.r1cs``: ``rows`` constraints x_{i+1} = x_i * x_i in
    circom's wire order (0 ONE, 1 the public output x_rows, 2 the public
    input x_0, then x_1 .. x_{rows-1}), and ``square_chain.wtns``, its
    witness at x. Returns x_rows."""
    from lurk_tpu_torch.coproc.circom import write_wtns

    def wire(i):
        return 2 if i == 0 else (1 if i == rows else 2 + i)
    folder.mkdir(parents=True, exist_ok=True)
    write_r1cs(folder / "square_chain.r1cs", prime,
               [({wire(i): 1}, {wire(i): 1}, {wire(i + 1): 1})
                for i in range(rows)], rows + 2, 1, 1)
    xs = [x]
    for _ in range(rows):
        xs.append(xs[-1] * xs[-1] % prime)
    write_wtns(folder / "square_chain.wtns", [1, xs[-1], x] + xs[1:-1],
               prime)
    return xs[-1]


def phase15(bound, dev) -> dict:
    """The circom coprocessor on the card. 15.1: a square chain of
    CIRCOM_ROWS rows over circom's bn128 prime (BN256's scalar field)
    written in the iden3 formats, packaged by ``python -m
    lurk_tpu_torch.cli circom`` in a child process and loaded;
    ``(square_chain 7)`` read and evaluated on a Store(BN256, cuda), its
    result 7^(2^CIRCOM_ROWS). 15.2: SuperNovaProver(rc=CIRCOM_RC) proves
    it (both shapes built cold and timed apart, W and T of 3 steps
    through K6); verify (W and E of 2 circuits) and a changed entry of
    the circom circuit's final W; the circom step's W against the plain
    version. 15.3-15.5: supernova.compress and verify_compressed with a
    changed input of the circom step."""
    from lurk_tpu_torch.coproc.circom import CircomGadget, circom_coprocessor
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.lem.evaluation import Lang, LangSetup, evaluate
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.parser import read_with_default_state
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import nova
    from lurk_tpu_torch.proof import supernova as sn
    from lurk_tpu_torch.store.core import Store
    from lurk_tpu_torch.symbol import user_sym
    from lurk_tpu_torch.utils import metrics

    # ---- 15.1: the gadget, packaged by the CLI, and its evaluation ----
    r = BN256_SCALAR.modulus
    t_start = time.perf_counter()
    src = Path(os.environ["LURK_TPU_CACHE"]) / "square_chain_src"
    expect = write_square_chain(src, CIRCOM_ROWS, 7, r)
    check(expect == pow(7, 2 ** CIRCOM_ROWS, r),
          "the written witness's output is not 7^(2^rows)")
    cli = subprocess.run(
        [sys.executable, "-m", "lurk_tpu_torch.cli", "circom", str(src),
         "--name", CIRCOM_REF], capture_output=True, text=True,
        cwd=Path(__file__).resolve().parent, timeout=300)
    check(cli.returncode == 0, f"the circom subcommand exited "
          f"{cli.returncode}: {cli.stderr[-2000:]}")
    check(cli.stdout.startswith("Gadget packaged at "),
          f"the circom subcommand printed {cli.stdout!r}")
    gadget = CircomGadget.load(CIRCOM_REF)
    check(gadget.r1cs.prime == r and len(gadget.r1cs.constraints)
          == CIRCOM_ROWS and gadget.static_wtns is not None,
          "the packaged gadget is not the written one")
    lang = Lang()
    lang.add_coprocessor(user_sym("square_chain"),
                         circom_coprocessor(gadget))
    store = Store(BN256_SCALAR, device=dev)
    t0 = time.perf_counter()
    frames = evaluate(LangSetup.nivc(lang), read_with_default_state(
        store, "(square_chain 7)"), store, 100)
    t_eval = time.perf_counter() - t0
    check([f.pc for f in frames] == [0, 0, 1, 0],
          f"pcs {[f.pc for f in frames]}, expected [0, 0, 1, 0]")
    check(store.fetch_num(frames[-1].output[0]) == expect,
          "(square_chain 7) is not 7^(2^rows)")
    print(f"phase 15.1: {CIRCOM_REF} ({CIRCOM_ROWS} rows over bn128) "
          f"packaged by `python -m lurk_tpu_torch.cli circom` "
          f"({cli.stdout.strip()}); (square_chain 7) evaluated in "
          f"{t_eval:.2f} s (the witness checked against the r1cs): "
          f"{len(frames)} frames, 7^(2^{CIRCOM_ROWS}) mod r")

    # ---- 15.2: the NIVC proof ----
    # the key as a new process sizes it, from the SRS on disk
    hk._SRS_MEM.clear()
    prover = sn.SuperNovaProver(rc=CIRCOM_RC, lang=lang, device=dev)
    times = {}
    metrics.drain()
    with CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        pp, proof = prover.prove_from_frames(store, frames)
        torch.cuda.synchronize()
        times["prove"] = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        pcs = [pc for pc, _, _ in proof.steps]
        shape_s = metrics.values("supernova.shape")
        times["shapes"] = sum(shape_s)
        s0, s1 = pp.shapes[0], pp.shapes[1]
        check(pcs == [0, 1, 0], f"steps of circuits {pcs}, expected "
              f"[0, 1, 0]")
        check(len(shape_s) == 2, f"{len(shape_s)} shapes built in the "
              f"prove, expected 2 (cold)")
        check(by == {"bn254-g1": 6}, f"MSM launches {by} in the prove, "
              f"expected 6 on BN254 (W and T of 3 steps)")
        # the circom step's W is the third commit
        key, vec, point = rec.records[2]
        check(vec.n == s1.num_aux, "the third commit is not the circom "
              "step's W")
        print(f"phase 15.2: SuperNovaProver(rc={CIRCOM_RC}, circom Lang, "
              f"cuda).prove_from_frames: {len(pcs)} steps (circuits {pcs}) "
              f"in {times['prove']:.1f} s, the shapes cold in "
              + " + ".join(f"{t:.1f}" for t in shape_s)
              + f" s (circuit 0: {s0.num_constraints} constraints, "
              f"{s0.num_aux} aux; the circom circuit: {s1.num_constraints}"
              f" constraints, {s1.num_aux} aux); key 2^"
              f"{len(pp.ck.gens).bit_length() - 1}; MSM launches {by}")
        reset_counts()
        t0 = time.perf_counter()
        ok = sn.verify(pp, proof)
        torch.cuda.synchronize()
        times["verify"] = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "supernova.verify rejects the circom NIVC proof")
        check(vby == {"bn254-g1": 4}, f"MSM launches {vby} in the verify, "
              f"expected 4 (W and E of 2 circuits)")
        records = list(rec.records)
    wit = proof.final_witnesses[1]
    bad_w = PackedVec(wit.w.arr.copy(), wit.w.n, wit.w.p)
    bad_w[wit.w.n // 2] = (bad_w[wit.w.n // 2] + 1) % wit.w.p
    finals = dict(proof.final_witnesses)
    finals[1] = nova.RelaxedWitness(bad_w, wit.e)
    check(not sn.verify(pp, dataclasses.replace(proof,
                                                final_witnesses=finals)),
          "verify accepts a proof whose circom circuit's final W was "
          "changed")
    plain, plain_ms = plain_commit(key.curve, key.table(),
                                   vec.arr.view(np.uint32).reshape(vec.n, 8))
    check(plain == point, "the circom step's W commit differs from the "
          "plain version")
    timed = kernel_alone(bound, records)
    check(len(timed) == 10, f"{len(timed)} commits timed, expected 10")
    print_classes("prove", timed[:6])
    print_classes("verify", timed[6:])
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 15.2: verify accepts ({times['verify']:.1f} s, MSM "
          f"launches {vby}) and rejects a changed entry of the circom "
          f"circuit's final W; the circom step's W ({vec.n} scalars) equals "
          f"the plain version on the card ({plain_ms:.1f} ms, host clock); "
          f"the {len(timed)} commits' kernels {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_ms / ms:.1%})")

    # ---- 15.3-15.5: compression ----
    def bads(cp):
        k = [pc for pc, _, _ in cp.steps].index(1)
        pc, inst, comm_t = cp.steps[k]
        x = list(inst.x)
        x[0] = (x[0] + 1) % r
        steps = list(cp.steps)
        steps[k] = (pc, nova.R1CSInstance(inst.comm_w, x), comm_t)
        return [("a changed input of the circom step",
                 dataclasses.replace(cp, steps=steps))]

    comp = compression(("15.3", "15.4", "15.5"), "supernova.compress",
                       bound, lambda: sn.compress(pp, proof),
                       lambda cp: sn.verify_compressed(pp, cp), bads)
    check(sorted(comp["cp"].spartans) == [0, 1],
          "the compressed proof lacks a circuit's Spartan proof")
    times["compress"] = comp["t_compress"]
    times["verify_compressed"] = comp["t_verify"]
    print("phase 15: the circom NIVC proof, seconds (host clock): "
          + ", ".join(f"{k} {v:.1f} (predicted {CIRCOM_PREDICTED[k]})"
                      for k, v in times.items())
          + f"; phase 15 in all {time.perf_counter() - t_start:.1f} s")
    return {"k6": {"launches": len(timed) + comp["launches"],
                   "ms": ms + comp["ms"],
                   "bound_ms": bound_ms + comp["bound_ms"],
                   "plain_ms": plain_ms},
            "times": times}


# phase 16's memoset coroutines, each part with the range PERF.md
# section 5 predicted before its first run on the card
MEMOSET_RC = 10
MEMOSET_EVEN = 100              # (even 100): 51 even and 50 odd queries
MEMOSET_FACTORIAL = 29          # (factorial 29): 30 keys, 29! below r
MEMOSET_PREDICTED = {"scope": "1-4", "public parameters": "5-10",
                     "prove": "8-15", "verify": "0.5-2",
                     "nivc prove + verify": "2-5", "env": "0.5-2",
                     "phase 16": "20-35"}


def memoset_scope(store, toplevel, name, n: int):
    """``(name n)`` queried on a scope of ``toplevel`` at MEMOSET_RC and
    finalized: (scope, result)."""
    from lurk_tpu_torch.coroutine.toplevel import scope_for
    scope = scope_for(toplevel, store, default_rc=MEMOSET_RC)
    result = scope.query(scope.query_cls(name, [store.num(n)]).to_ptr(
        store))
    scope.finalize_transcript()
    return scope, result


def phase16(bound, gen, dev) -> dict:
    """The memoset coroutines on the card. 16.1: the sample toplevel's
    ``(even 100)`` on a Store(BN256, cuda) scope at rc = MEMOSET_RC: 101
    queries, the transcript hydrated through K1 (a launch a batched
    wave, every digest against host hashing on a second store, ``r``
    equal), each wave's kernel timed alone; MemosetCycleProver(cuda):
    its public parameters cold and timed (3 primary circuits, no disk
    cache), 11 steps starting at circuit 1, K6 launches by curve, step
    0's W1 against the plain version, verify and a changed zn[7].
    16.2: ``(factorial 29)`` through MemosetProver(cuda): 3 steps, the
    result 29!, verify and a changed zi[7] and step input. 16.3:
    tests/test_memoset_env.py's two lookups at rc = 2 through
    MemosetProver(cuda)."""
    import math
    from lurk_tpu_torch.coroutine import prove as mp
    from lurk_tpu_torch.coroutine import prove_cycle as mpc
    from lurk_tpu_torch.coroutine.env import EnvCircuitQuery, EnvQuery
    from lurk_tpu_torch.coroutine.memoset import Scope
    from lurk_tpu_torch.coroutine.toplevel import ToplevelCircuitQuery
    from lurk_tpu_torch.examples import sample_toplevel
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import nova
    from lurk_tpu_torch.store import core
    from lurk_tpu_torch.store.core import Store
    from lurk_tpu_torch.symbol import user_sym

    r = BN256_SCALAR.modulus
    t_start = time.perf_counter()
    times = {}
    toplevel, factorial, even, odd = sample_toplevel()

    # ---- 16.1: (even 100), its transcript hydrated through K1 ----
    reset_counts()
    with WaveRecorder() as rec:
        t0 = time.perf_counter()
        store = Store(BN256_SCALAR, device=dev)
        scope, result = memoset_scope(store, toplevel, even, MEMOSET_EVEN)
        torch.cuda.synchronize()
        times["scope"] = time.perf_counter() - t0
        launches = K.launches
    big = rec.waves
    counts = {i: len(k) for i, k in scope.unique_inserted_keys.items()}
    check(store.fetch_num(result) == 1, "(even 100) is not 1")
    check(len(scope.queries) == 101 and counts == {1: 51, 2: 50},
          f"{len(scope.queries)} queries, unique keys by index {counts}; "
          f"expected 101 and {{1: 51, 2: 50}}")
    check(scope.verify_balance(), "the multiset does not balance")
    check(launches == len(big), f"{launches} K1 launches for {len(big)} "
          f"batched waves")
    threshold, core._DEVICE_WAVE_THRESHOLD = core._DEVICE_WAVE_THRESHOLD, \
        1 << 62                       # every wave of the host store on the host
    try:
        host = Store(BN256_SCALAR, device="cpu")
        host_scope, _ = memoset_scope(host, toplevel, even, MEMOSET_EVEN)
    finally:
        core._DEVICE_WAVE_THRESHOLD = threshold
    check(host_scope.r == scope.r, "r differs from host hashing")
    for iv, d in store.z_cache.items():
        check(host.hash_ptr_val(iv) == d, f"hydrated digest of {iv} differs")
    print(f"phase 16.1: sample_toplevel's (even {MEMOSET_EVEN}) on a "
          f"Store(BN256, cuda) scope at rc={MEMOSET_RC}: result 1, "
          f"{len(scope.queries)} queries (unique keys by circuit {counts}), "
          f"the multiset balances; query + finalize {times['scope']:.2f} s: "
          f"{len(big)} batched waves {big}, {launches} K1 launches"
          + ("" if big else " (no wave of 64 or more)")
          + f"; {len(store.z_cache)} digests and r equal host hashing")
    k1 = {"launches": launches, "ms": 0.0, "plain_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0}
    if big:
        k1_ms, k1_plain, k1_bound, k1_err, _ = waves_alone(bound, gen, dev,
                                                           big)
        k1.update(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                  max_abs_err=k1_err)

    # the keys as a new process sizes them, from the SRS on disk
    hk._SRS_MEM.clear()
    prover = mpc.MemosetCycleProver(MEMOSET_RC,
                                    ToplevelCircuitQuery(toplevel),
                                    device=dev)
    t0 = time.perf_counter()
    pp = prover.public_params(scope, len(toplevel))
    times["public parameters"] = time.perf_counter() - t0
    s1s, s2 = pp.shapes1, pp.shape2
    check(pp.n_circuits == 3 and all(c.base_allowed for c in pp.cfg1s),
          f"{pp.n_circuits} primary circuits, base_allowed "
          f"{[c.base_allowed for c in pp.cfg1s]}")
    print(f"phase 16.1: MemosetCycleProver(rc={MEMOSET_RC}, cuda)'s public "
          f"parameters cold in {times['public parameters']:.1f} s: primary "
          + ", ".join(f"pc {pc} {s.num_constraints} constraints, "
                      f"{s.num_aux} aux" for pc, s in enumerate(s1s))
          + f"; secondary {s2.num_constraints}, {s2.num_aux}; keys BN254 "
          f"2^{len(pp.ck1.gens).bit_length() - 1}, Grumpkin "
          f"2^{len(pp.ck2.gens).bit_length() - 1}")
    pcs = [st.index for st in prover.steps(scope)]
    with CommitRecorder() as crec:
        reset_counts()
        t0 = time.perf_counter()
        pp, proof = prover.prove_from_scope(scope)
        torch.cuda.synchronize()
        times["prove"] = time.perf_counter() - t0
        by = dict(M.launches_by_curve)
        n = proof.n
        check(n == 11 and pcs == [1] * 6 + [2] * 5,
              f"{n} steps over circuits {pcs}; expected 11, six of "
              f"circuit 1 then five of circuit 2")
        check(by == {"bn254-g1": 2 * n, "grumpkin": 2 * n},
              f"MSM launches by curve {by} in the prove, expected "
              f"{2 * n} + {2 * n} (W1 and T1 of each step; W2 of each, T2 "
              f"of steps 1-{n - 1} and finish's)")
        check(K.launches == 0, f"{K.launches} K1 launches in the prove "
              f"(one key's transcript a wave)")
        key, vec, point = crec.records[0]
        check(key.curve.name == "bn254-g1" and vec.n == s1s[1].num_aux,
              "the first commit is not step 0's W1")
        print(f"phase 16.1: MemosetCycleProver.prove_from_scope: {n} steps "
              f"(circuits {pcs}) in {times['prove']:.1f} s, MSM launches "
              f"{by}")
        reset_counts()
        t0 = time.perf_counter()
        ok = mpc.verify(pp, proof)
        torch.cuda.synchronize()
        times["verify"] = time.perf_counter() - t0
        vby = dict(M.launches_by_curve)
        check(ok, "prove_cycle.verify rejects the memoset proof")
        check(vby == {"bn254-g1": 6, "grumpkin": 2}, f"MSM launches {vby} "
              f"in the verify, expected 6 + 2 (W and E a circuit)")
        records = list(crec.records)
    zn = list(proof.zn)
    zn[7] = (zn[7] + 1) % r
    check(not mpc.verify(pp, dataclasses.replace(proof, zn=zn)),
          "verify accepts the memoset proof with zn[7] changed")
    words = vec.arr.view(np.uint32).reshape(vec.n, 8)
    plain, plain_ms = plain_commit(key.curve, key.table(), words)
    check(plain == point, "step 0's W1 commit differs from the plain "
          "version")
    timed = kernel_alone(bound, records)
    check(len(timed) == 4 * n + 8, f"{len(timed)} commits timed, expected "
          f"{4 * n + 8}")
    print_classes("prove", timed[:4 * n])
    print_classes("verify", timed[4 * n:])
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 16.1: verify accepts ({times['verify']:.1f} s, MSM "
          f"launches {vby}) and rejects zn[7] changed; step 0's W1 "
          f"({vec.n} scalars) equals the plain version on the card "
          f"({plain_ms:.1f} ms, host clock); the {len(timed)} commits' "
          f"kernels {ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_ms / ms:.1%})")

    # ---- 16.2: (factorial 29) through MemosetProver ----
    store = Store(BN256_SCALAR, device=dev)
    with CommitRecorder() as crec:
        reset_counts()
        t0 = time.perf_counter()
        scope, result = memoset_scope(store, toplevel, factorial,
                                      MEMOSET_FACTORIAL)
        nprover = mp.MemosetProver(MEMOSET_RC, ToplevelCircuitQuery(toplevel),
                                   device=dev)
        npp, nproof = nprover.prove_from_scope(scope)
        nby = dict(M.launches_by_curve)
        ok = mp.verify(npp, nproof)
        torch.cuda.synchronize()
        times["nivc prove + verify"] = time.perf_counter() - t0
        vby = {k: v - nby.get(k, 0) for k, v in M.launches_by_curve.items()}
        nrecords = list(crec.records)
    check(store.fetch_num(result) == math.factorial(MEMOSET_FACTORIAL) < r,
          f"(factorial {MEMOSET_FACTORIAL}) is not {MEMOSET_FACTORIAL}!")
    check([i for i, _, _ in nproof.steps] == [0, 0, 0],
          f"steps of circuits {[i for i, _, _ in nproof.steps]}, expected "
          f"[0, 0, 0]")
    check(nby == {"bn254-g1": 6} and vby == {"bn254-g1": 2},
          f"MSM launches {nby} in the prove and {vby} in the verify, "
          f"expected 6 (W and T of 3 steps) and 2 (W and E)")
    check(ok, "coroutine.prove.verify rejects the memoset NIVC proof")
    zi = list(nproof.zi)
    zi[7] = (zi[7] + 1) % r
    check(not mp.verify(npp, dataclasses.replace(nproof, zi=zi)),
          "verify accepts the NIVC proof with zi[7] changed")
    idx, inst, comm_t = nproof.steps[1]
    bad = nova.R1CSInstance(inst.comm_w, [(inst.x[0] + 1) % r]
                            + inst.x[1:])
    check(not mp.verify(npp, dataclasses.replace(
        nproof, steps=[nproof.steps[0], (idx, bad, comm_t),
                       nproof.steps[2]])),
          "verify accepts the NIVC proof with a step input changed")
    shape = npp.shapes[0]
    ntimed = kernel_alone(bound, nrecords)
    check(len(ntimed) == 8, f"{len(ntimed)} commits timed, expected 8")
    nms, nbound = sum(t[2] for t in ntimed), sum(t[3] for t in ntimed)
    print(f"phase 16.2: MemosetProver(rc={MEMOSET_RC}, cuda) on (factorial "
          f"{MEMOSET_FACTORIAL}) = {MEMOSET_FACTORIAL}!: 3 steps of "
          f"{shape.num_constraints} constraints, {shape.num_aux} aux, key "
          f"2^{len(npp.ck.gens).bit_length() - 1}; query, prove and verify "
          f"{times['nivc prove + verify']:.1f} s; MSM launches {nby} + "
          f"{vby}; verify rejects zi[7] and a step input changed; kernels "
          f"{nms:.3f} ms, bound {nbound:.3f} ms ({nbound / nms:.1%})")

    # ---- 16.3: the env lookups of tests/test_memoset_env.py ----
    store = Store(BN256_SCALAR, device=dev)
    a, b, c = (store.intern_symbol(user_sym(x)) for x in "abc")
    empty = store.intern_empty_env()
    env = empty
    for var, v in ((a, 1), (b, 2), (c, 3), (a, 4)):
        env = store.push_binding(var, store.num(v), env)
    with CommitRecorder() as crec:
        reset_counts()
        t0 = time.perf_counter()
        escope = Scope(store, EnvQuery, default_rc=2)
        got = [escope.query(EnvQuery(c, env).to_ptr(store)),
               escope.query(EnvQuery(b, empty).to_ptr(store))]
        escope.finalize_transcript()
        epp, eproof = mp.MemosetProver(2, EnvCircuitQuery(),
                                       device=dev).prove_from_scope(escope)
        ok = mp.verify(epp, eproof)
        torch.cuda.synchronize()
        times["env"] = time.perf_counter() - t0
        eby = dict(M.launches_by_curve)
        erecords = list(crec.records)
    nil = store.intern_nil()
    check(got == [store.cons(store.num(3), store.intern_t()),
                  store.cons(nil, nil)], "the env lookups' results differ")
    check(ok and eproof.zi[7] == 0, "the env lookups' proof does not "
          "verify")
    check(eby == {"bn254-g1": 6}, f"MSM launches {eby}, expected 6 (W and "
          f"T of 2 steps, W and E)")
    etimed = kernel_alone(bound, erecords)
    ems, ebound = sum(t[2] for t in etimed), sum(t[3] for t in etimed)
    print(f"phase 16.3: the env lookups (c through 2 hops, b in the empty "
          f"env) through MemosetProver(rc=2, cuda): "
          f"{len(eproof.steps)} steps, verified; {times['env']:.1f} s; MSM "
          f"launches {eby}; kernels {ems:.3f} ms, bound {ebound:.3f} ms")
    times["phase 16"] = time.perf_counter() - t_start
    print("phase 16: the memoset coroutines, seconds (host clock): "
          + ", ".join(f"{k} {v:.1f} (predicted {MEMOSET_PREDICTED[k]})"
                      for k, v in times.items()))
    return {"k1": k1,
            "k6": {"launches": len(timed) + len(ntimed) + len(etimed),
                   "ms": ms + nms + ems,
                   "bound_ms": bound_ms + nbound + ebound,
                   "plain_ms": plain_ms},
            "times": times}


# phase 17 (the chain server): the server's default rc, its two counters
# (tests/test_chain_server.py), and each part's seconds with the range
# PERF.md section 5 predicted before its first run on the card
CHAIN_RC = 10
CHAIN_COUNTER = ("(letrec ((add (lambda (counter x)"
                 " (let ((counter (+ counter x)))"
                 " (cons counter (add counter))))))"
                 " (add 0))")
CHAIN_COMMIT_COUNTER = ("(letrec ((add (lambda (counter x)"
                        " (let ((counter (+ counter x)))"
                        " (cons counter (commit (add counter)))))))"
                        " (add 0))")
CHAIN_PREDICTED = {"chain prove": "5-10", "chain compress": "5-8",
                   "chain verify": "1-2.5", "stream prove": "1-3",
                   "stream compress": "5-8", "stream verify": "1-2.5",
                   "dump": "0.2-0.5", "resume": "0.2-1",
                   "entry point": "10-20", "phase 17": "45-80"}
CHAIN_TIMEOUT_S = 600


def http_json(port: int, path: str, body=None):
    """(status, JSON) of a GET to 127.0.0.1:port, or of a POST of
    ``body``."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=CHAIN_TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def chain_result(resp: dict) -> int:
    return int(resp["result"]["root"]["digest"], 16)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def last_chain_times(what: str, call: int = None) -> dict:
    """The last call's ``chain.*`` seconds, keyed ``"{what} prove"``,
    ``"... compress"``, ``"... verify"`` (and a stream's ``"dump"``),
    each followed by the call's number when given."""
    from lurk_tpu_torch.utils import metrics
    suffix = "" if call is None else f" {call}"
    out = {f"{what} {p}{suffix}": metrics.values(f"chain.{p}")[-1]
           for p in ("prove", "compress", "verify")}
    if what == "stream":
        out[f"dump{suffix}"] = metrics.values("chain.dump_session")[-1]
    return out


class ChainCall:
    """One call of a chain server's state, run with every count at 0:
    its K1 waves and launches, its K6 launches by curve, and each
    recorded commit's kernel timed alone (``kernel_alone``)."""

    def __init__(self, bound, what: str, call):
        from lurk_tpu_torch.msm import kernel as M
        from lurk_tpu_torch.poseidon import kernel as K
        reset_counts()
        with WaveRecorder() as rec, CommitRecorder() as crec:
            t0 = time.perf_counter()
            self.resp = call()
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            self.k1 = K.launches
            self.by = dict(M.launches_by_curve)
        self.waves = rec.waves
        check("error" not in self.resp, f"{what}: {self.resp.get('error')}")
        check(self.k1 == len(self.waves), f"{what}: {self.k1} K1 launches "
              f"for {len(self.waves)} batched waves")
        self.timed = kernel_alone(bound, crec.records)
        check(len(self.timed) == sum(self.by.values()),
              f"{what}: {len(self.timed)} commits of 64 or more scalars, "
              f"{sum(self.by.values())} K6 launches")
        self.ms = sum(t[2] for t in self.timed)
        self.bound_ms = sum(t[3] for t in self.timed)

    def line(self) -> str:
        from lurk_tpu_torch.utils import metrics
        parts = ""
        if "proof_verified" in self.resp:
            parts = ", ".join(f"{k} {metrics.values('chain.' + k)[-1]:.2f}"
                              for k in ("prove", "compress", "verify")) + \
                " s; "
        return (f"{self.seconds:.2f} s ({parts}K1 waves {self.waves or 'none'}"
                f" of 64 or more, {self.k1} launches; K6 {self.by or 'none'},"
                f" kernels alone {self.ms:.3f} ms, bound "
                f"{self.bound_ms:.3f} ms)")


def phase17(bound, gen, dev) -> dict:
    """The chain server on the card. 17.1: ChainState over the commit
    counter on a Store(BN256, cuda) at rc = CHAIN_RC, behind ``serve`` on
    a free local port: GET /config, POST /chain 9 without a proof, then
    12 with one (the Nova cycle's public parameters cold at CHAIN_RC,
    the BN254 key sized from the SRS on disk as a new server's, prove,
    compress, verify): results 9 and 21, proof_verified. 17.2:
    StreamState over the plain counter with a session file: proving
    calls 3 and 4, the session dumped after each (size and write time),
    StreamState.resume in a fresh CUDA store (its accumulator's JSON
    equal to the dumped one), a third proving call 5: results 3, 7 and
    12, proof_steps growing, the resumed snark's finish() verified. 17.3:
    ``python -m lurk_tpu_torch.cli.chain_server --device cuda`` in a
    child on a free port: GET /config and POST /chain without a proof,
    then the child interrupted (exit 0). Each call runs with every
    count at 0; its K1 waves, K6 launches by curve and each commit's
    kernel alone are printed with prove, compress and verify seconds."""
    import signal
    from lurk_tpu_torch.cli import chain_server as cs
    from lurk_tpu_torch.cli.lurk_proof import cycle_snark_to_json
    from lurk_tpu_torch.fields import BN256_SCALAR
    from lurk_tpu_torch.lem.evaluation import evaluate
    from lurk_tpu_torch.parser import read_with_default_state
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import prover_cycle as pcy
    from lurk_tpu_torch.store.core import Store

    t_start = time.perf_counter()
    times = {}
    calls = []
    hk._SRS_MEM.clear()        # the BN254 key as a new server sizes it

    def callable_of(store, src):
        return evaluate(None, read_with_default_state(store, src), store,
                        1000)[-1].output[0]

    # ---- 17.1: ChainState behind the HTTP server ----
    store = Store(BN256_SCALAR, device=dev)
    state = cs.ChainState(store, callable_of(store, CHAIN_COMMIT_COUNTER),
                          rc=CHAIN_RC)
    server = cs.serve(state, port=0)
    port = server.server_address[1]
    try:
        status, cfg = http_json(port, "/config")
        check(status == 200 and cfg["field"] == BN256_SCALAR.name
              and cfg["rc"] == CHAIN_RC and cfg["calls"] == 0,
              f"GET /config: {status} {cfg}")
        plain = ChainCall(bound, "POST /chain 9", lambda: http_json(
            port, "/chain", {"arg_num": 9, "prove": False})[1])
        proved = ChainCall(bound, "POST /chain 12 with a proof",
                           lambda: http_json(port, "/chain", {
                               "arg_num": 12, "prove": True})[1])
    finally:
        server.shutdown()
        server.server_close()
    check([chain_result(plain.resp), chain_result(proved.resp)] == [9, 21],
          f"results {chain_result(plain.resp)}, {chain_result(proved.resp)};"
          f" expected 9, 21")
    check(proved.resp.get("proof_verified") is True
          and proved.resp["proof_steps"] >= 1,
          f"the proving call: {proved.resp.get('proof_verified')}, "
          f"{proved.resp.get('proof_steps')} steps")
    check(proved.by.get("bn254-g1", 0) > 0 and proved.by.get("grumpkin", 0)
          > 0, f"the proving call's K6 launches {proved.by}")
    times.update(last_chain_times("chain"))
    calls += [plain, proved]
    print(f"phase 17.1: ChainState (commit counter, rc={CHAIN_RC}) behind "
          f"serve on 127.0.0.1:{port}: /config {cfg}; /chain 9 without a "
          f"proof -> 9 in {plain.line()}; /chain 12 with a proof -> 21, "
          f"{proved.resp['iterations']} iterations, "
          f"{proved.resp['proof_steps']} steps, verified, in {proved.line()}")

    # ---- 17.2: StreamState, one proof across calls, dump and resume ----
    session = Path(os.environ["LURK_TPU_CACHE"]) / "chain_stream.json"
    store = Store(BN256_SCALAR, device=dev)
    stream = cs.StreamState(store, callable_of(store, CHAIN_COUNTER),
                            rc=CHAIN_RC, session=session)
    results, steps = [], []
    for i, n in enumerate((3, 4)):
        call = ChainCall(bound, f"stream call {n}",
                         lambda: stream.chain(store.num(n)))
        calls.append(call)
        results.append(chain_result(call.resp))
        steps.append(call.resp["proof_steps"])
        check(call.resp.get("proof_verified") is True,
              f"stream call {n} does not verify")
        times.update(last_chain_times("stream", i + 1))
        print(f"phase 17.2: stream call {n} -> {results[-1]}, "
              f"{call.resp['proof_steps']} steps, verified, in {call.line()};"
              f" session {session.stat().st_size:,} bytes written in "
              f"{times[f'dump {i + 1}']:.2f} s")
    dumped = json.loads(session.read_text())["snark"]
    t0 = time.perf_counter()
    resumed = cs.StreamState.resume(session, Store(BN256_SCALAR, device=dev))
    times["resume"] = time.perf_counter() - t0
    check(cycle_snark_to_json(resumed.snark) == dumped and resumed.calls == 2,
          "the resumed accumulator differs from the dumped one")
    call = ChainCall(bound, "stream call 5 (resumed)",
                     lambda: resumed.chain(resumed.store.num(5)))
    calls.append(call)
    results.append(chain_result(call.resp))
    steps.append(call.resp["proof_steps"])
    times.update(last_chain_times("stream", 3))
    check(results == [3, 7, 12], f"stream results {results}, expected "
          f"[3, 7, 12]")
    check(steps[0] < steps[1] < steps[2], f"proof_steps {steps} do not grow")
    check(call.resp.get("proof_verified") is True,
          "the resumed stream's call does not verify")
    t0 = time.perf_counter()
    ok = pcy.CycleNovaProver.verify(resumed.pp, resumed.snark.finish())
    torch.cuda.synchronize()
    check(ok, "CycleNovaProver.verify rejects the resumed stream's proof")
    print(f"phase 17.2: resumed in a fresh Store(BN256, cuda) in "
          f"{times['resume']:.2f} s (accumulator equal to the dump); call 5 "
          f"-> 12, {steps[2]} steps, verified, in {call.line()}; session "
          f"{session.stat().st_size:,} bytes in {times['dump 3']:.2f} s; the "
          f"finished proof of {steps[2]} steps verifies "
          f"({time.perf_counter() - t0:.2f} s)")

    # ---- 17.3: the entry point in a child process ----
    port = free_port()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "lurk_tpu_torch.cli.chain_server", "--device",
         "cuda", "--port", str(port), "--callable", CHAIN_COUNTER],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        cfg = None
        while cfg is None and time.perf_counter() - t0 < CHAIN_TIMEOUT_S:
            if child.poll() is not None:
                check(False, f"the chain server child exited "
                      f"{child.returncode}: {child.stderr.read()[-2000:]}")
            try:
                cfg = http_json(port, "/config")
            except OSError:
                time.sleep(0.2)
        check(cfg is not None and cfg[0] == 200 and cfg[1]["rc"] == CHAIN_RC,
              f"the child's /config: {cfg}")
        status, out = http_json(port, "/chain", {"arg_num": 3})
        check(status == 200 and chain_result(out) == 3
              and "proof_steps" not in out, f"the child's /chain: {status} "
              f"{out}")
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGINT)
        try:
            stdout, stderr = child.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            stdout, stderr = child.communicate()
    times["entry point"] = time.perf_counter() - t0
    check(child.returncode == 0 and "listening on 127.0.0.1" in stdout,
          f"the chain server child: exit {child.returncode}, stdout "
          f"{stdout!r}, stderr {stderr[-2000:]!r}")
    print(f"phase 17.3: python -m lurk_tpu_torch.cli.chain_server --device "
          f"cuda --port {port}: /config {cfg[1]}, /chain 3 -> 3, stopped "
          f"(exit 0) in {times['entry point']:.1f} s")

    times["phase 17"] = time.perf_counter() - t_start
    waves = [w for c in calls for w in c.waves]
    k1 = {"launches": sum(c.k1 for c in calls), "ms": 0.0, "plain_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0}
    if waves:
        k1_ms, k1_plain, k1_bound, k1_err, _ = waves_alone(bound, gen, dev,
                                                           waves)
        k1.update(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                  max_abs_err=k1_err)
    k6 = {"launches": sum(len(c.timed) for c in calls),
          "ms": sum(c.ms for c in calls),
          "bound_ms": sum(c.bound_ms for c in calls), "plain_ms": 0.0}

    def predicted(k: str) -> str:          # "stream prove 2": its kind's
        return CHAIN_PREDICTED.get(k) or CHAIN_PREDICTED[k.rsplit(" ", 1)[0]]
    print("phase 17: the chain server, seconds (host clock): "
          + ", ".join(f"{k} {v:.2f} (predicted {predicted(k)})"
                      for k, v in times.items()))
    return {"k1": k1, "k6": k6, "times": times}


# phase 18 (the example and bench entry points, scripts/torch_*.py): the
# trie program's rc, the sha256 IVC's and the synthesis bench's, and each
# part's seconds with the range PERF.md section 5 predicted before its
# first run on the card
TRIE_NIVC_RC = 100
SHA256_IVC_RC = 10
SYNTHESIS_RC = 100
ENTRY_PREDICTED = {"trie public parameters": "25-45", "trie prove": "20-45",
                   "trie verify": "2-5", "sha256_ivc": "15-40",
                   "synthesis": "0.5-3", "phase 18": "80-120"}


def phase18(bound, gen, dev, trie, store) -> dict:
    """The entry points' new paths on the card, through the scripts'
    functions. 18.1, ``torch_benches.py trie-nivc`` at rc = TRIE_NIVC_RC
    on phase 14's evaluated and hydrated trie store (``trie`` = (store,
    lang, frames)): the trie Lang's public parameters cold and timed,
    ``trie_prove`` (SuperNovaCycleProver: 25 steps, 20 Lurk and 5
    coprocessor, through the fork pool, then verify), K6 launches by
    curve, the result 12688603180, a changed final W1 rejected, the
    first coprocessor step's W1 against the plain version. 18.2,
    ``torch_sha256_ivc.py``'s ``prove_sha256_ivc``: ``(sha256_ivc_1 1)``
    through NovaProver(rc=SHA256_IVC_RC, cuda), the inlined step's shape
    cold (built in the prove, timed), 1 step, verify and a changed
    final W rejected. 18.3, ``torch_benches.py synthesis`` at
    SYNTHESIS_RC on phase 2's store (``store``), timed. 18.4,
    ``torch_itcalc.py``'s default table. Each part runs with every count
    at 0; its K1 waves and K6 commits are timed alone."""
    from lurk_tpu_torch.examples import TRIE_RESULT
    from lurk_tpu_torch.hostlib.r1cs import PackedVec
    from lurk_tpu_torch.msm import kernel as M
    from lurk_tpu_torch.poseidon import kernel as K
    from lurk_tpu_torch.proof import hyperkzg as hk
    from lurk_tpu_torch.proof import nova, witness_pool
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc
    from lurk_tpu_torch.proof.prover import NovaProver
    from lurk_tpu_torch.utils import metrics
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import torch_benches
    import torch_itcalc
    import torch_sha256_ivc

    t_start = time.perf_counter()
    times = {}

    # ---- 18.1: trie-nivc at rc = 100 on phase 14's trie store ----
    tstore, lang, frames = trie
    prover = psc.SuperNovaCycleProver(rc=TRIE_NIVC_RC, lang=lang, device=dev)
    hk._SRS_MEM.clear()        # the keys as a new process sizes them
    with WaveRecorder() as wrec, CommitRecorder() as rec:
        reset_counts()
        t0 = time.perf_counter()
        pp = psc.sn_cycle_public_params(tstore, TRIE_NIVC_RC,
                                        *prover.setup_funcs(), lang,
                                        device=dev)
        torch.cuda.synchronize()
        times["trie public parameters"] = time.perf_counter() - t0
        chunks = prover.chunks(tstore, frames)
        pcs = [c[0].pc for c in chunks]
        check(len(chunks) == 25 and sum(pc != 0 for pc in pcs) == 5,
              f"{len(chunks)} steps, {sum(pc != 0 for pc in pcs)} of them "
              f"coprocessor steps; expected 25 and 5")
        check(witness_pool.uses_pool(prover.check_steps, len(chunks)),
              "the fork pool is off")
        reset_counts()
        t0 = time.perf_counter()
        _, proof, times["trie prove"] = torch_benches.trie_prove(
            TRIE_NIVC_RC, tstore, lang, frames, dev)
        # trie_prove verifies after the prove it times
        times["trie verify"] = time.perf_counter() - t0 - times["trie prove"]
        by = dict(M.launches_by_curve)
        k1_launches = K.launches
        n_commits = len([r for r in rec.records if r[1].n >= 64])
        records = list(rec.records)
    waves = wrec.waves
    check(proof.n == 25, f"{proof.n} folding steps, expected 25")
    out = tstore.hash_ptr(frames[-1].output[0])
    check(tstore.fetch_num(frames[-1].output[0]) == TRIE_RESULT
          and proof.zn[:2] == [out.tag, out.digest],
          "the trie proof's output is not the reference's result")
    want = {"bn254-g1": 2 * proof.n + 2 * pp.n_circuits,
            "grumpkin": 2 * proof.n + 2}
    check(by == want and sum(by.values()) == n_commits,
          f"MSM launches by curve {by} in the prove and verify, for "
          f"{n_commits} commits of 64 or more; expected {want} (W1, T1 and "
          f"W2, T2 a step; W and E of each circuit and of the secondary)")
    check(k1_launches == len(waves), f"{k1_launches} K1 launches for "
          f"{len(waves)} batched waves")
    w = proof.w1s[0].w
    bad_w = PackedVec(w.arr.copy(), w.n, w.p)
    bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
    w1s = list(proof.w1s)
    w1s[0] = nova.RelaxedWitness(bad_w, proof.w1s[0].e)
    check(not psc.SuperNovaCycleProver.verify(
        pp, dataclasses.replace(proof, w1s=w1s)),
        "verify accepts a trie proof whose final W1 was changed")
    # step k's W1 is commit 4k (W1, T1, W2 a step, T2 of the step before
    # from step 1 on): the first coprocessor step's against plain
    k = pcs.index(next(pc for pc in pcs if pc != 0))
    key, vec, point = records[4 * k]
    check(key.curve.name == "bn254-g1" and vec.n == pp.shapes1[pcs[k]]
          .num_aux, f"commit {4 * k} is not step {k}'s W1")
    plain, plain_ms = plain_commit(key.curve, key.table(),
                                   vec.arr.view(np.uint32).reshape(vec.n, 8))
    check(plain == point, f"step {k}'s W1 (circuit {pcs[k]}) differs from "
          f"the plain version")
    timed = kernel_alone(bound, records)
    check(len(timed) == n_commits, f"{len(timed)} commits timed, expected "
          f"{n_commits}")
    print_classes("trie prove and verify", timed)
    ms, bound_ms = sum(t[2] for t in timed), sum(t[3] for t in timed)
    print(f"phase 18.1: torch_benches.trie_prove(rc={TRIE_NIVC_RC}) on phase "
          f"14's trie store: {proof.n} steps (circuits {pcs}, fork pool), "
          f"result {TRIE_RESULT}; public parameters cold "
          f"{times['trie public parameters']:.1f} s (primary "
          + ", ".join(f"pc {pc} {s.num_constraints} constraints"
                      for pc, s in enumerate(pp.shapes1))
          + f"; keys BN254 2^{len(pp.ck1.gens).bit_length() - 1}, Grumpkin "
          f"2^{len(pp.ck2.gens).bit_length() - 1}), prove "
          f"{times['trie prove']:.1f} s, verify {times['trie verify']:.1f} "
          f"s; MSM launches {by} (prove and verify), K1 {k1_launches} "
          f"(waves {waves}); a changed final W1 rejected; step {k}'s W1 "
          f"(circuit {pcs[k]}, {vec.n} scalars) equals the plain version "
          f"({plain_ms:.1f} ms, host clock); kernels {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_ms / ms:.1%})")
    k1 = {"launches": k1_launches, "ms": 0.0, "plain_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0}
    if waves:
        k1_ms, k1_plain, k1_bound, k1_err, _ = waves_alone(bound, gen, dev,
                                                           waves)
        k1.update(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound,
                  max_abs_err=k1_err)

    # ---- 18.2: (sha256_ivc_1 1) through NovaProver(rc=10) ----
    # (its 2^21 key from the SRS that 18.1 left in memory)
    with CommitRecorder() as rec:
        metrics.drain()
        reset_counts()
        _, ipp, iproof, iframes, times["sha256_ivc"] = \
            torch_sha256_ivc.prove_sha256_ivc(1, dev, SHA256_IVC_RC)
        iby = dict(M.launches_by_curve)
        shape_s = metrics.values("nova.shape")
        irecords = list(rec.records)
    check(len(iframes) == 2 and len(iproof.steps) == 1,
          f"{len(iframes)} frames, {len(iproof.steps)} steps; expected 2 "
          f"and 1")
    check(len(shape_s) == 1, "the inlined step's shape was not built")
    check(iby == {"bn254-g1": 4}, f"MSM launches {iby} in the prove and "
          f"verify, expected 4 on BN254 (W and T, then W and E)")
    w = iproof.final_witness.w
    bad_w = PackedVec(w.arr.copy(), w.n, w.p)
    bad_w[w.n // 2] = (bad_w[w.n // 2] + 1) % w.p
    check(not NovaProver.verify(ipp, nova.FoldingProof(
        iproof.steps, nova.RelaxedWitness(bad_w, iproof.final_witness.e),
        iproof.z0, iproof.zi)),
        "verify accepts the sha256 IVC proof with its final W changed")
    itimed = kernel_alone(bound, irecords)
    ims, ibound = sum(t[2] for t in itimed), sum(t[3] for t in itimed)
    s = ipp.shape
    print(f"phase 18.2: torch_sha256_ivc.prove_sha256_ivc(1): "
          f"NovaProver(rc={SHA256_IVC_RC}, cuda), {len(iframes)} frames, "
          f"{len(iproof.steps)} step; the inlined step {s.num_constraints} "
          f"constraints, {s.num_aux} aux, its shape cold in "
          f"{shape_s[0]:.1f} s; key 2^{len(ipp.ck.gens).bit_length() - 1}; "
          f"evaluate, prove and verify {times['sha256_ivc']:.1f} s; MSM "
          f"launches {iby}; a changed final W rejected; kernels "
          f"{ims:.3f} ms, bound {ibound:.3f} ms ({ibound / ims:.1%})")

    # ---- 18.3: the synthesis bench at rc = 100 on phase 2's store ----
    with WaveRecorder() as wrec:
        reset_counts()
        rec18, w = torch_benches.bench_synthesis(SYNTHESIS_RC, dev, store)
        torch.cuda.synchronize()
        s_launches = K.launches
    times["synthesis"] = rec18["seconds"]
    check(rec18["frames"] == SYNTHESIS_RC and len(w) > 0,
          f"the synthesis bench's line {rec18}")
    check(s_launches == len(wrec.waves), f"{s_launches} K1 launches for "
          f"{len(wrec.waves)} batched waves")
    print(f"phase 18.3: torch_benches.bench_synthesis({SYNTHESIS_RC}) on "
          f"phase 2's store: one MultiFrame's witness ({len(w)} entries) in "
          f"{rec18['seconds']:.3f} s; its hydration {len(wrec.waves)} K1 "
          f"waves {wrec.waves}")
    if wrec.waves:
        sk = waves_alone(bound, gen, dev, wrec.waves)
        for key_, v in zip(("ms", "plain_ms", "bound_ms"), sk[:3]):
            k1[key_] += v
        k1["launches"] += s_launches
        k1["max_abs_err"] = max(k1["max_abs_err"], sk[3])

    # ---- 18.4: itcalc's default table ----
    print("phase 18.4: torch_itcalc.py's default table (setup 7, loop 7):")
    print(torch_itcalc.table(torch_itcalc.Prog(7, 7)))

    times["phase 18"] = time.perf_counter() - t_start
    print("phase 18: the entry points, seconds (host clock): "
          + ", ".join(f"{k} {v:.1f} (predicted {ENTRY_PREDICTED[k]})"
                      for k, v in times.items()))
    return {"k1": k1,
            "k6": {"launches": len(timed) + len(itimed), "ms": ms + ims,
                   "bound_ms": bound_ms + ibound, "plain_ms": plain_ms},
            "times": times}


def imad_rate(sms: int):
    """(32-bit IMAD per second, SM clock in MHz under that load) from
    csrc/imad_rate.cu: CUDA events over IMAD_LAUNCHES back-to-back
    launches of independent mad.lo.cc / madc.hi.cc chains, nvidia-smi's
    SM clock read while they run."""
    import ctypes
    from lurk_tpu_torch import native
    lib = native.load("imad_rate")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lurk_imad_probe.argtypes = [p, i, i, i, p]
    lib.lurk_imad_probe.restype = i
    lib.lurk_imad_count.argtypes = [i, i, i]
    lib.lurk_imad_count.restype = ctypes.c_longlong
    blocks = sms * IMAD_BLOCKS_PER_SM
    out = torch.empty(blocks * IMAD_THREADS, dtype=torch.int32, device="cuda")

    def launch():
        err = lib.lurk_imad_probe(
            p(out.data_ptr()), blocks, IMAD_THREADS, IMAD_ITERS,
            p(torch.cuda.current_stream().cuda_stream))
        check(err == 0, f"IMAD probe launch failed: CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(IMAD_LAUNCHES):
        launch()
    end.record()
    clock = float(nvidia_smi("clocks.sm", ",nounits"))
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    imad = lib.lurk_imad_count(blocks, IMAD_THREADS, IMAD_ITERS)
    return IMAD_LAUNCHES * imad / (ms * 1e-3), clock


def sass_mix(name: str) -> None:
    """Print, for each kernel of csrc/<name>.cu's library, its SASS
    instructions (cuobjdump --dump-sass, static counts over the whole
    kernel) by kind: IMAD (every IMAD form, IMAD.WIDE counted once), the
    integer adds and selects around the products (IADD3, SEL, ISETP,
    LOP3, SHF), shared-memory loads and stores, shuffles, and the rest."""
    from lurk_tpu_torch import native
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(f"  {name}.cu: cuobjdump not found, no SASS counts")
        return
    out = subprocess.run([tool, "--dump-sass",
                          str(native.library_path(name))],
                         capture_output=True, text=True, timeout=300).stdout
    kinds = [("IMAD", ("IMAD",)), ("add/select", ("IADD3", "SEL", "ISETP",
                                                  "LOP3", "SHF")),
             ("LDS/STS", ("LDS", "STS")), ("SHFL", ("SHFL",))]
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys([k for k, _ in kinds] + ["other"], 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn is None or m is None:
            continue
        op = m.group(1).split(".")[0]
        kind = next((k for k, ops in kinds if op in ops), "other")
        counts[fn][kind] += 1
    for fn, c in counts.items():
        total = sum(c.values())
        print(f"  {name}.cu SASS {fn}: {total} instructions, "
              + ", ".join(f"{k} {v} ({v / total:.0%})" for k, v in c.items()))


def build_and_probe():
    """Phase 0: the card, the builds (with ptxas's registers and stack)
    and the IMAD probe. Returns (nvidia-smi line, Bound)."""
    from lurk_tpu_torch import native
    smi = nvidia_smi("name,power.limit")
    clock = float(nvidia_smi("clocks.max.sm", ",nounits"))
    props = torch.cuda.get_device_properties(0)
    bound = Bound(props.multi_processor_count, clock)
    print(f"card: {smi}; {props.multi_processor_count} SMs, max SM clock "
          f"{clock:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    shape_builds = start_shape_builds()
    times = native.build_many(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(SOURCES)} "
          f"sources at once (nvcc, sm_90a)")
    for name in SOURCES:
        print(f"  {name}.cu: {times[name]:.1f} s")
        for line in native.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())
    for name in ("poseidon", "poseidon_dense"):
        sass_mix(name)
    t0 = time.perf_counter()
    host_times = native.build_host()
    print(f"host C++ (g++, at once): {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{n}.cpp {s:.1f} s" for n, s in host_times.items()))
    sms = props.multi_processor_count
    rate, load_clock = imad_rate(sms)
    at_load = sms * IMAD_PER_CLK_PER_SM * load_clock * 1e6
    print(f"IMAD probe: {rate:.4e} 32-bit IMAD/s measured (mad.lo.cc / "
          f"madc.hi.cc chains, {IMAD_BLOCKS_PER_SM * IMAD_THREADS} threads "
          f"an SM), SM clock under it {load_clock:.0f} MHz; the bounds "
          f"assume {bound.imad_per_s:.4e} ({IMAD_PER_CLK_PER_SM}/clk/SM at "
          f"the max clock {clock:.0f} MHz), {rate / bound.imad_per_s:.1%} "
          f"of it; {IMAD_PER_CLK_PER_SM}/clk/SM at {load_clock:.0f} MHz is "
          f"{at_load:.4e}, {rate / at_load:.1%} of that")
    return smi, bound, shape_builds


def elapsed(phases: str, t_all: float) -> None:
    print(f"-- phase {phases} done at {time.perf_counter() - t_all:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
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

    # ---- phase 0: card, build, IMAD probe ----
    smi, bound, shape_builds = build_and_probe()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    shape_sweep(shape_builds, gen, dev)

    # ---- phase 1: kernel against plain, oracle and anchors ----
    t0 = time.perf_counter()
    batches = shape_batches("poseidon")
    max_err = poseidon_against_plain(FIELDS, gen, dev, K.poseidon_hash,
                                     K.poseidon_hash_plain, "sparse",
                                     batches)
    anchors(K.hash_batch, "poseidon", dev, "K1")
    anchor = Store(BN256_SCALAR, device=dev)
    xs = anchor.intern_symbol(user_sym("x"))
    fun = anchor.intern_fun(anchor.list([xs]), xs, anchor.intern_empty_env())
    threshold, core._DEVICE_WAVE_THRESHOLD = core._DEVICE_WAVE_THRESHOLD, 1
    before = K.launches
    anchor.hydrate_z_cache()            # every wave through the kernel
    core._DEVICE_WAVE_THRESHOLD = threshold
    check(K.launches > before, "the anchor's waves missed the kernel")
    z = anchor.hash_ptr(fun)
    for n in (1, batches[1]):
        check(set(K.hash_batch(BN256_SCALAR, 3, [[0, z.tag, z.digest]] * n,
                               device=dev)) == {COMMIT_ID_FUN},
              f"(lambda (x) x) commitment anchor, B={n}")
    print(f"phase 1: 16 field/arity pairs at B={batches} (group, thread "
          f"shape), 0 mismatches, anchors hold in both shapes "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 2: main path ----
    K.launches = 0
    with WaveRecorder() as rec:
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
    big = rec.waves                     # (arity, size) of batched waves
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
    ms, plain_ms, bound_ms, err, bound_by = waves_alone(bound, gen, dev,
                                                        big)
    max_err = max(max_err, err)

    # ---- phase 3: size ----
    for name, b in SIZES:
        field = FIELDS[name]
        x = random_preimages(field, 4, b, gen, dev)
        k_ms = time_ms(lambda: K.poseidon_hash(field, 4, x), TIMED_LAUNCHES)
        b_ms, by = bound.of(field, 4, b, const_bytes[4])
        line = (f"phase 3: Poseidon-4 {name} B=2^{b.bit_length() - 1} "
                f"({shape_of('poseidon', b)} shape): {k_ms:.3f} ms/launch, "
                f"{b / k_ms * 1e3:,.0f} hashes/s; bound {b_ms:.3f} ms ({by}: "
                f"{imad_per_hash(field, 4)} IMAD per hash at "
                f"{bound.imad_per_s:.3e} IMAD/s), {b_ms / k_ms:.1%} of it; "
                f"the kernel's schedule does "
                f"{imad_per_hash(field, 4, kernel_schedule=True)} IMAD per "
                f"hash")
        if b == 1 << 17:
            max_err = max(max_err, compare(field, 4, x, K.poseidon_hash,
                                           K.poseidon_hash_plain)[0])
            p_ms = time_ms(lambda: K.poseidon_hash_plain(field, 4, x), 1)
            line += f"; plain {p_ms:.0f} ms"
        print(line)
    elapsed("0-3", t_all)
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
    msm = phase4(bound, dev, shard_devices)
    elapsed("4", t_all)

    # ---- phase 5: K2 ----
    dense = phase5(bound, gen, dev, host, shard_devices)
    elapsed("5", t_all)

    # ---- phase 6: the folded Poseidon and the bench ----
    folded = phase6(bound, gen, dev)
    elapsed("6", t_all)

    # ---- phase 7: the step circuit ----
    phase7(store, frames)
    elapsed("7", t_all)

    # ---- phase 8: the fold of fib(100), its commits through K6 ----
    fold = phase8(bound, store, frames[:PHASE8_FRAMES])
    elapsed("8", t_all)

    # ---- phase 9: the cycle fold of fib(100), BN254 and Grumpkin ----
    cycle = phase9(bound, store, frames)
    elapsed("9", t_all)

    # ---- phase 10: compression and its verifier ----
    comp = phase10(bound, cycle.pop("pp"), cycle.pop("proof"))
    elapsed("10", t_all)
    e2e = cycle["t_prove"] + comp["t_compress"] + comp["t_verify"]
    print(f"fib(100) prove + compress + verify {e2e:.1f} s (prove "
          f"{cycle['t_prove']:.1f}, its loading of the public parameters "
          f"from the disk cache included, + compress "
          f"{comp['t_compress']:.1f} + verify {comp['t_verify']:.1f}; the "
          f"public parameters' cold build, before, {cycle['t_setup']:.1f} "
          f"s), {len(frames) / e2e:.2f} frames/s")

    # ---- phase 11: the Nova cycle, its compression and verifiers ----
    nova_cycle = phase11(bound, store, frames[:PHASE11_FRAMES])
    elapsed("11", t_all)

    # ---- phase 12: NIVC, its compression and verifiers ----
    nivc = phase12(bound, store, frames[:PHASE12_FRAMES])
    elapsed("12", t_all)
    for name, part in ((f"the Nova cycle (its first {PHASE11_FRAMES} "
                        f"frames)", nova_cycle),
                       (f"NIVC (its first {PHASE12_FRAMES} frames)", nivc)):
        print(f"fib(100) through {name}: prove {part['t_prove']:.1f} s + "
              f"compress {part['t_compress']:.1f} s + verify "
              f"{part['t_verify']:.1f} s")

    # ---- phase 13: the CLI, load --prove, verify, inspect ----
    cli = phase13(bound, comp["cp"])
    elapsed("13", t_all)
    print(f"fib(100) through the CLI: load --prove "
          f"{cli['times']['load --prove']:.1f} s (read, evaluate, hydrate, "
          f"the public parameters from the disk cache, prove, compress, "
          f"self-check, files), verify in a new process "
          f"{cli['times']['verify (new process)']:.1f} s")

    # ---- phase 14: coprocessors, the trie program and sha256 NIVC ----
    coproc = phase14(bound, gen, dev)
    elapsed("14", t_all)
    t = coproc["times"]
    print(f"sha256 NIVC (sha256_nivc_1, rc={SHA256_RC}) through the "
          f"SuperNova cycle: prove {t['prove']:.1f} s + compress "
          f"{t['compress']:.1f} s + verify {t['verify']:.1f} s (the public "
          f"parameters' cold build, before, {t['public parameters']:.1f} "
          f"s); through NIVC: prove + verify {coproc['t_nivc']:.1f} s, "
          f"compress {coproc['t_nivc_compress']:.1f} s, verify_compressed "
          f"{coproc['t_nivc_verify']:.1f} s")

    # ---- phase 15: the circom coprocessor, a 16,384-row gadget ----
    circ = phase15(bound, dev)
    elapsed("15", t_all)
    t = circ["times"]
    print(f"circom NIVC ({CIRCOM_ROWS} rows, rc={CIRCOM_RC}): prove "
          f"{t['prove']:.1f} s (its shapes {t['shapes']:.1f}) + verify "
          f"{t['verify']:.1f} s; compress {t['compress']:.1f} s, "
          f"verify_compressed {t['verify_compressed']:.1f} s")

    # ---- phase 16: the memoset coroutines ----
    memo = phase16(bound, gen, dev)
    elapsed("16", t_all)
    t = memo["times"]
    print(f"memoset (even {MEMOSET_EVEN}) through MemosetCycleProver(rc="
          f"{MEMOSET_RC}): public parameters {t['public parameters']:.1f} s, "
          f"prove {t['prove']:.1f} s + verify {t['verify']:.1f} s; "
          f"(factorial {MEMOSET_FACTORIAL}) through MemosetProver "
          f"{t['nivc prove + verify']:.1f} s; phase 16 {t['phase 16']:.1f} s")

    # ---- phase 17: the chain server ----
    chain = phase17(bound, gen, dev)
    elapsed("17", t_all)
    t = chain["times"]
    print(f"the chain server (rc={CHAIN_RC}): ChainState's proving call "
          f"prove {t['chain prove']:.1f} s (the public parameters cold) + "
          f"compress {t['chain compress']:.1f} s + verify "
          f"{t['chain verify']:.1f} s; StreamState's calls prove "
          + " / ".join(f"{t[f'stream prove {i}']:.1f}" for i in (1, 2, 3))
          + " s, compress "
          + " / ".join(f"{t[f'stream compress {i}']:.1f}" for i in (1, 2, 3))
          + f" s; phase 17 {t['phase 17']:.1f} s")

    # ---- phase 18: the example and bench entry points ----
    entry = phase18(bound, gen, dev, coproc["trie"], store)
    elapsed("18", t_all)
    t = entry["times"]
    print(f"the entry points: the trie program through the SuperNova cycle "
          f"(rc={TRIE_NIVC_RC}, 25 steps): public parameters "
          f"{t['trie public parameters']:.1f} s, prove {t['trie prove']:.1f} "
          f"s + verify {t['trie verify']:.1f} s; (sha256_ivc_1 1) through "
          f"NovaProver(rc={SHA256_IVC_RC}): {t['sha256_ivc']:.1f} s; the "
          f"synthesis bench at rc={SYNTHESIS_RC} {t['synthesis']:.3f} s; "
          f"phase 18 {t['phase 18']:.1f} s")

    for part in (fold, cycle, comp, nova_cycle, nivc, cli["k6"],
                 coproc["k6"], circ["k6"], memo["k6"], chain["k6"],
                 entry["k6"]):
        for k in ("launches", "ms", "bound_ms"):
            msm[k] += part[k]
    for part in (cli["k1"], coproc["k1"], memo["k1"], chain["k1"],
                 entry["k1"]):
        for k in ("launches", "ms", "bound_ms"):
            sparse[k] += part[k]
    for part in (coproc["k1"], memo["k1"], chain["k1"], entry["k1"]):
        sparse["plain_ms"] += part["plain_ms"]
        sparse["max_abs_err"] = max(sparse["max_abs_err"],
                                    part["max_abs_err"])
    for part in (cycle, nova_cycle, nivc, coproc["k6"], circ["k6"],
                 memo["k6"], entry["k6"]):
        msm["plain_ms"] += part["plain_ms"]
    msm["plain_of"] = ("the 2^20 commit, step 0's W2 and step 1's T2 of "
                       "the cycle fold, step 0's W2 of the Nova cycle, a "
                       "2^12 HyperKZG commit of NIVC's compress, the "
                       "sha256 step's W1, the circom step's W, the memoset "
                       "cycle's step 0 W1, the trie program's first "
                       "coprocessor step's W1")

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
