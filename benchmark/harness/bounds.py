"""The least work of the port's two kernels on the path, counted from
their inputs alone, whatever kernel does the work: the roofline
arithmetic of the benchmark.

Frozen copy of ``chip_smoke.py`` (the repository root): the constants
of lines 247-266 (``HBM_BYTES_PER_S``, ``IMAD_PER_CLK_PER_SM``,
``PRODUCT`` .. ``ADD``), ``imad_per_hash`` (lines 361-397, here taking
the width and round numbers instead of the port's spec), ``Bound``
(lines 400-433, ``of`` taking the constants' bytes from the width and
round numbers), ``MSM_BOUND_MAX_C``, ``msm_digits`` and
``least_msm_work`` (lines 443-519, on a device given as an argument).
``benchmark/tests/test_bench_bounds.py`` holds them against the
originals.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# 32-bit integer multiply-adds per clock per SM, compute capability
# 9.0's nominal rate, at the card's maximum SM clock
IMAD_PER_CLK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0
# 32-bit multiply-adds (IMAD) per operation on 8 x 32-bit limbs, a wide
# 32x32->64 product counting 2 (low and high word)
PRODUCT = 2 * 64               # a*b: 64 wide products
SQUARE = 2 * 36                # a*a: n(n+1)/2 = 36, cross terms doubled
REDC = 2 * 64 + 8              # Montgomery reduction: m*p, and m itself
MUL = PRODUCT + REDC           # one general field product, 264
REDC_WIDE = 9 * (2 * 8 + 1)    # nine steps of a wide reduction, 153
# an affine point into a bucket by XYZZ mixed addition (madd-2008-s),
# and two buckets by RCB15 Alg. 7
MADD = 8 * PRODUCT + 2 * SQUARE + 9 * REDC
ADD = 12 * PRODUCT + 9 * REDC
MSM_BOUND_MAX_C = 22


def imad_per_hash(t: int, rf: int, rp: int) -> int:
    """The least IMAD a Poseidon hash of width ``t`` with ``rf`` full and
    ``rp`` partial rounds needs on the sparse schedule: squarings as
    squarings, each mix row summed before its one reduction."""
    arity = t - 1
    sboxes, dense_rows, sparse = rf * t + rp, rf * t, rp

    def row(k):
        return k * PRODUCT + REDC
    sbox = 2 * (SQUARE + REDC) + row(1)     # x^2, x^4, x^5
    convert = arity * row(1) + REDC         # inputs in, the digest out
    return (convert + sboxes * sbox + dense_rows * row(t)
            + sparse * (row(t) + (t - 1) * row(1)))


class Bound:
    """Least time the card could take: the larger of bytes over the
    memory rate and integer multiply-adds over the card's IMAD rate."""

    def __init__(self, sms: int = H100_SMS,
                 clock_mhz: float = H100_MAX_SM_MHZ):
        self.imad_per_s = sms * IMAD_PER_CLK_PER_SM * clock_mhz * 1e6
        self.sms, self.clock_mhz = sms, clock_mhz

    def _max(self, ops: float, nbytes: float):
        ops_ms = 1e3 * ops / self.imad_per_s
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        return max(ops_ms, bytes_ms), \
            ("operations" if ops_ms >= bytes_ms else "bytes")

    def of(self, t: int, rf: int, rp: int, b: int):
        """``b`` Poseidon digests of width ``t`` at their least work; the
        bytes: each input and digest once, and the round constants and
        the MDS matrix once (32 bytes an element)."""
        ops = b * imad_per_hash(t, rf, rp)
        const_bytes = 32 * ((rf + rp) * t + t * t)
        return self._max(ops, b * t * 16 * 4 + const_bytes)

    def msm(self, words: np.ndarray, table_rows: int, device="cuda"):
        """The MSM of these reduced scalar words at its least work over
        the signed window widths c = 1 .. MSM_BOUND_MAX_C: in each window
        one mixed addition for each non-zero digit that is not the first
        of its bucket, and 2 additions per bucket up to the highest
        occupied one for the running sums (the windows' doublings left
        out); bytes: the table, the scalars and the result once.
        Returns (ms, bound_by, the least width, its mixed additions)."""
        ops, c, madds = least_msm_work(words, device)
        nbytes = table_rows * 64 + words.shape[0] * 32 + 96
        return (*self._max(ops, nbytes), c, madds)


def msm_digits(w: torch.Tensor, c: int) -> torch.Tensor:
    """Every window's signed digit of width ``c`` (top window unsigned)
    of the scalars ``w`` (int64[n, 8] of 32-bit words), as magnitudes
    in int64[windows, n]: the windows of s + H less 2^(c-1) - 1, with
    H = (2^(c-1) - 1) in every window but the top one."""
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


def least_msm_work(words: np.ndarray, device="cuda"):
    """(IMAD count, width, mixed additions) of the cheapest signed-window
    bucket MSM of ``uint32[n, 8]`` scalar words over the widths 1 ..
    MSM_BOUND_MAX_C, counted with torch on ``device``. A width whose
    lower bound exceeds the work already found is not counted exactly:
    it can be neither the least nor tie with it."""
    w = torch.from_numpy(np.ascontiguousarray(words).astype(np.int64)) \
        .to(device)
    n = w.shape[0]

    def exact(c, d, sums):
        bins = int(d.max()) + 1
        offsets = torch.arange(d.shape[0], device=device)[:, None] * bins
        sizes = torch.bincount((d + offsets).flatten(),
                               minlength=d.shape[0] * bins) \
            .view(-1, bins)[:, 1:]
        madds = int(sizes.sum() - torch.count_nonzero(sizes))
        return madds * MADD + 2 * sums * ADD, c, madds

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
