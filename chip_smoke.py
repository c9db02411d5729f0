#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lurk_tpu_torch``) on one GPU.

Usage: python3 chip_smoke.py        (needs one CUDA card and nvcc)

Phases, each fatal on failure:
  0. card: nvidia-smi name and power limit, versions, kernel build;
  1. kernel against plain: the CUDA Poseidon against its plain PyTorch
     version on the card, 4 fields x arities 3/4/6/8 at B = 4096 (random
     canonical preimages plus all-0 and all-(p-1) lanes), 8 lanes each
     against the host oracle, and the reference anchors through the kernel;
  2. main path: read fib(100) -> Store(BN256, cuda) -> LEM evaluate (800
     frames) -> hydrate_z_cache, launch count = waves >= the threshold,
     every hydrated digest against host hashing on a second store; then
     the kernel and its plain version at the main path's wave shapes;
  3. size: Poseidon-4 over Pallas at B = 2^17 and 2^20 and over BN256 at
     2^20, against the bound (integer multiply-add throughput).

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card or without the rest of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SEED = 20240601
PHASE1_BATCH = 4096
SIZES = [("pallas", 1 << 17), ("pallas", 1 << 20), ("bn256", 1 << 20)]
TIMED_LAUNCHES = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
IMAD_PER_CLK_PER_SM = 64       # 32-bit integer multiply-add, cc 9.0
# 32-bit multiply-adds (IMAD) per operation on 8 x 32-bit limbs, a wide
# 32x32->64 product counting 2 (low and high word)
PRODUCT = 2 * 64               # a*b: 64 wide products
SQUARE = 2 * 36                # a*a: n(n+1)/2 = 36, cross terms doubled
REDC = 2 * 64 + 8              # Montgomery reduction: m*p, and m itself
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


def imad_per_hash(field, arity: int, kernel_schedule: bool = False) -> int:
    """IMAD per hash of the sparse schedule: by default the least the
    function needs (squarings as squarings, each mix row summed before
    its one reduction); with ``kernel_schedule`` what csrc/poseidon.cu
    does (every field product a full CIOS, PRODUCT + REDC)."""
    from lurk_tpu_torch.poseidon.spec import poseidon_spec
    spec = poseidon_spec(field, arity)
    t, rf, rp = spec.width, spec.full_rounds, spec.partial_rounds
    sboxes, dense_rows, sparse = rf * t + rp, rf * t, rp
    if kernel_schedule:       # 3 products per S-box, t per row, 2t-1
        products = arity + 1 + 3 * sboxes + t * dense_rows \
            + sparse * (2 * t - 1)
        return products * (PRODUCT + REDC)
    def row(k):
        return k * PRODUCT + REDC
    convert = arity * row(1) + REDC         # inputs in, the digest out
    sbox = 2 * (SQUARE + REDC) + row(1)     # x^2, x^4, x^5
    return (convert + sboxes * sbox + dense_rows * row(t)
            + sparse * (row(t) + (t - 1) * row(1)))


class Bound:
    """Least time the card could take: the larger of bytes over the
    memory rate and integer multiply-adds over the card's IMAD rate."""

    def __init__(self, sms: int, clock_mhz: float):
        self.imad_per_s = sms * IMAD_PER_CLK_PER_SM * clock_mhz * 1e6
        self.sms, self.clock_mhz = sms, clock_mhz

    def of(self, field, arity: int, b: int, const_bytes: int):
        ops = b * imad_per_hash(field, arity)
        nbytes = b * (arity + 1) * 16 * 4 + const_bytes
        ops_ms = 1e3 * ops / self.imad_per_s
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        return max(ops_ms, bytes_ms), \
            ("operations" if ops_ms >= bytes_ms else "bytes")


def compare(field, arity, x, kernel_mod):
    """Kernel against plain on the same input: (max |diff|, digests)."""
    got = kernel_mod.poseidon_hash(field, arity, x)
    want = kernel_mod.poseidon_hash_plain(field, arity, x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    mism = int((got != want).any(dim=0).sum())
    check(mism == 0, f"{field.name}/{arity}: {mism} lanes differ from plain")
    return err, got


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
    from lurk_tpu_torch.poseidon.host import hash_preimage
    from lurk_tpu_torch.store import core
    from lurk_tpu_torch.store.core import Store
    from lurk_tpu_torch.symbol import user_sym

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
    native.build("poseidon")
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in native.build_log("poseidon").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    max_err = 0

    # ---- phase 1: kernel against plain, oracle and anchors ----
    t0 = time.perf_counter()
    for name, field in FIELDS.items():
        for arity in (3, 4, 6, 8):
            x = random_preimages(field, arity, PHASE1_BATCH, gen, dev)
            err, out = compare(field, arity, x, K)
            max_err = max(max_err, err)
            b = PHASE1_BATCH
            lanes = [0, 1, 2, 3, b // 4, b // 2, b - 2, b - 1]
            pres = [lane_ints(x[a], lanes) for a in range(arity)]
            want = [hash_preimage(field, [pres[a][j] for a in range(arity)])
                    for j in range(len(lanes))]
            check(lane_ints(out, lanes) == want,
                  f"{name}/{arity}: kernel differs from the host oracle")
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
        max_err = max(max_err, compare(BN256_SCALAR, arity, x, K)[0])
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
            max_err = max(max_err, compare(field, 4, x, K)[0])
            p_ms = time_ms(lambda: K.poseidon_hash_plain(field, 4, x), 1)
            line += f"; plain {p_ms:.0f} ms"
        print(line)

    print(json.dumps({"kernels": [{
        "name": "poseidon_sparse", "route": "cuda",
        "source": "lurk_tpu_torch/csrc/poseidon.cu",
        "replaces": "lurk_tpu/poseidon/pallas_nib12_opt.py:141",
        "launches": launches, "mismatches": 0, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if "operations" in bound_by else "bytes",
        "library_ms": None,
    }]}))
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
