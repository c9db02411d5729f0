"""Plain PyTorch 256-bit Montgomery arithmetic.

Elements are ``int64[..., 16, B]`` tensors of 16-bit limbs, least
significant first, with the batch on the last axis. A product of two
limbs is below 2^32 and a column of a schoolbook product sums at most 16
such terms (times the terms of a dot product, at most 9 here), so every
column stays below 2^41. Montgomery form uses R = 2^256. No function
loops over the limbs: carries resolve by lookahead and a reduction
works on the whole width, so a call costs a few dozen tensor
operations whatever the batch.

This is the CPU path of the port's kernels and the reference their CUDA
versions are held against on the card; it replaces the JAX package's
limb cores (``ops/{limbs,limbs17,nibbles,nib12}.py``) for this slice.
Every function works for the four Lurk fields (``fields.FIELDS``); all
moduli are below 2^255, which the bounds below rely on.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..fields import FieldSpec

LIMB_BITS = 16
N_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * N_LIMBS
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class MontField:
    spec: FieldSpec
    pinv: int          # -p^{-1} mod R
    r2: int            # R^2 mod p

    @property
    def modulus(self) -> int:
        return self.spec.modulus

    def to_mont_int(self, v: int) -> int:
        return (v << R_BITS) % self.modulus


@lru_cache(maxsize=None)
def mont_field(spec: FieldSpec) -> MontField:
    p = spec.modulus
    if p >= 1 << (R_BITS - 1):
        raise ValueError(f"modulus of {spec.name} is not below 2^255")
    pinv = (-pow(p, -1, 1 << R_BITS)) % (1 << R_BITS)
    return MontField(spec, pinv, (1 << (2 * R_BITS)) % p)


def int_to_limbs(v: int, n: int = N_LIMBS) -> List[int]:
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(n)]


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Python ints in [0, 2^256) -> ``uint16[len(values), 16]``."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(len(values), N_LIMBS)


def limbs_to_ints(limbs: np.ndarray) -> List[int]:
    """``[n, 16]`` limbs in [0, 2^16) -> Python ints."""
    raw = np.ascontiguousarray(limbs, dtype="<u2").tobytes()
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(limbs.shape[0])]


def ints_to_words(values) -> np.ndarray:
    """Ints in [0, 2^256), as a (nested) sequence or object array, ->
    ``uint32[..., 8]`` little-endian 32-bit words, by numpy operations
    over all values at once."""
    v = np.asarray(values, dtype=object)
    limbs = np.empty((*v.shape, 4), dtype="<u8")
    for k in range(4):
        limbs[..., k] = ((v >> (64 * k)) & _MASK64).astype(np.uint64)
    return limbs.view("<u4")


def words_to_ints(words: np.ndarray) -> np.ndarray:
    """``[..., 8]`` 32-bit words (any integer dtype holding their bits)
    -> object array of ints."""
    w = np.asarray(words).astype(np.uint32).astype(object)
    out = w[..., 0]
    for k in range(1, 8):
        out = out | (w[..., k] << (32 * k))
    return out


def from_ints(values: Sequence[int], device="cpu") -> torch.Tensor:
    """Python ints -> ``int64[16, B]`` (values must be below 2^256)."""
    arr = ints_to_limbs(values).astype(np.int64).T.copy()
    return torch.from_numpy(arr).to(device)


def to_ints(x: torch.Tensor) -> List[int]:
    """``[16, B]`` limbs -> Python ints."""
    return limbs_to_ints(x.detach().cpu().numpy().T)


# ---------------------------------------------------------------------------
# carries
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _limb_consts(values: tuple, n: int, device: torch.device) -> torch.Tensor:
    """``int64[len(values), n, 1]`` limbs of Python ints, cached."""
    rows = [int_to_limbs(v, n) for v in values]
    return torch.tensor(rows, dtype=torch.int64, device=device).unsqueeze(-1)


@lru_cache(maxsize=None)
def _limb_index(n: int, device: torch.device) -> torch.Tensor:
    """``[n, 1]``: 0..n-1, the shift of each limb's bit."""
    return torch.arange(n, device=device).unsqueeze(-1)


def _ripple(v: torch.Tensor):
    """Final carry pass, by lookahead instead of a loop over the limbs.

    Every limb of ``v`` must lie in [0, 2^17 - 2], so a limb passes on a
    carry of at most 1: it generates one (v >= 2^16), propagates the
    incoming one (v = 2^16 - 1) or stops it. With one bit per limb in G
    (generate) and P (propagate), the carries are those of the binary
    sum (G | P) + G, which one int64 addition resolves (n <= 33 limbs).
    Returns (limbs in [0, 2^16), carry out of the top limb); ``v`` is
    overwritten."""
    n = v.shape[-2]
    idx = _limb_index(n, v.device)
    gen = v >> LIMB_BITS
    g = (gen << idx).sum(dim=-2)
    a = ((v == MASK).long() << idx).sum(dim=-2) | g
    carries = (a + g) ^ a ^ g                   # bit i: carry into limb i
    v += (carries.unsqueeze(-2) >> idx) & 1
    return v.bitwise_and_(MASK), (carries >> n) & 1


def _normalize(cols: torch.Tensor, passes: int = 2,
               exact: bool = True) -> torch.Tensor:
    """Non-negative columns below 2^47 -> limbs in [0, 2^16) of their
    value mod 2^(16 n). Each pass leaves every column below 2^16 plus the
    carry of the one below; two passes bring them under 2^17 - 2
    (2^47 -> 2^16 + 2^31 -> 2^16 + 2^15 + 1), then one lookahead pass
    finishes. With ``exact=False`` the lookahead is skipped: the columns
    stay below 2^17 and hold the value mod 2^(16 n) only up to a multiple
    of 2^(16 n) (below 2 * 2^(16 n))."""
    for _ in range(passes):
        hi = cols >> LIMB_BITS
        cols = cols & MASK
        cols[..., 1:, :] += hi[..., :-1, :]
    return _ripple(cols)[0] if exact else cols


@lru_cache(maxsize=None)
def _reduce_consts(mf: MontField, bound: int,
                   device: torch.device) -> torch.Tensor:
    """``[bound - 1, 17, 1]``: the limbs of 2^272 - k p, k < bound."""
    total = 1 << (LIMB_BITS * (N_LIMBS + 1))
    return _limb_consts(tuple(total - k * mf.modulus
                              for k in range(1, bound)), N_LIMBS + 1, device)


def _reduce(mf: MontField, x: torch.Tensor, bound: int) -> torch.Tensor:
    """Normalized x (17 limbs) below bound * p -> canonical 16 limbs.

    All candidates x - k p (k < bound) are formed at once as
    x + (2^272 - k p); the carry out says whether x >= k p, and the
    number of such k picks the candidate."""
    if bound <= 1:
        return x[..., :N_LIMBS, :]
    comps = _reduce_consts(mf, bound, x.device)
    comps = comps.view(bound - 1, *([1] * (x.dim() - 2)), N_LIMBS + 1, 1)
    y, ge = _ripple(x.unsqueeze(0) + comps)
    k = ge.sum(dim=0)
    out = x[..., :N_LIMBS, :].clone()
    for j in range(1, bound):
        torch.where((k == j).unsqueeze(-2), y[j - 1, ..., :N_LIMBS, :], out,
                    out=out)
    return out


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def canonical(mf: MontField, x: torch.Tensor) -> torch.Tensor:
    """Any 16-limb value (< 2^256) -> its residue in [0, p)."""
    top = torch.zeros_like(x[..., :1, :])
    return _reduce(mf, torch.cat([x, top], dim=-2),
                   (1 << R_BITS) // mf.modulus + 1)


def _carried(cands: torch.Tensor) -> torch.Tensor:
    """Candidates (16 limbs each below 3 * 2^16) -> 17 normalized limbs,
    the 17th the carry out of 2^256 (one pass, then the lookahead)."""
    top = torch.zeros_like(cands[..., :1, :])
    return _normalize(torch.cat([cands, top], dim=-2), passes=1)


def add(mf: MontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b: a + b and a + b + 2^256 - p are
    carried at once, and the second's carry out of 2^256 (a + b >= p)
    picks it."""
    c = _limb_consts(((1 << R_BITS) - mf.modulus,), N_LIMBS, a.device)[0]
    s = a + b
    v = _carried(torch.stack([s, s + c]))
    return torch.where(v[1, ..., N_LIMBS:, :] == 1, v[1, ..., :N_LIMBS, :],
                       v[0, ..., :N_LIMBS, :])


def sub(mf: MontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b: d = a + (2^256 - 1 - b) + 1 =
    a - b + 2^256 and d + p are carried at once; d's carry out of 2^256
    (a >= b) picks d, else d + p."""
    p_limbs = _limb_consts((mf.modulus,), N_LIMBS, a.device)[0]
    one = _limb_consts((1,), N_LIMBS, a.device)[0]
    d = a + (MASK - b) + one
    v = _carried(torch.stack([d, d + p_limbs]))
    return torch.where(v[0, ..., N_LIMBS:, :] == 1, v[0, ..., :N_LIMBS, :],
                       v[1, ..., :N_LIMBS, :])


@lru_cache(maxsize=None)
def _toeplitz_index(device: torch.device) -> torch.Tensor:
    """``[33, 16]``: k - i where 0 <= k - i < 16, else 16 (a zero)."""
    k = torch.arange(2 * N_LIMBS + 1).unsqueeze(1)
    d = k - torch.arange(N_LIMBS).unsqueeze(0)
    return torch.where((d >= 0) & (d < N_LIMBS), d, N_LIMBS).to(device)


def _product_cols(a: torch.Tensor, b: torch.Tensor,
                  dim: Optional[int] = None) -> torch.Tensor:
    """Schoolbook columns of a*b: ``[..., 33, B]``, column k the sum of
    a_i*b_j over i+j = k (the top two columns are headroom for REDC);
    summed over the leading axis ``dim`` when it is given. Limbs must be
    below 2^16, or below 2^17 when one operand is a constant.

    When one operand is the same for every lane (B = 1: a constant), the
    columns are one float64 matrix product with its Toeplitz matrix,
    exact because every column sum stays far below 2^53. Otherwise row i
    of the outer product is skewed by i without a loop: written into
    rows of width 32 and read back at width 31, element (i, j) lands in
    column i + j."""
    if b.shape[-1] == 1 and a.shape[-1] != 1:
        a, b = b, a
    if a.shape[-1] == 1:
        padded = torch.cat([a[..., 0], torch.zeros_like(a[..., :1, 0])], -1)
        toeplitz = padded[..., _toeplitz_index(a.device)].double()
        cols = torch.matmul(toeplitz, b.double())
        if dim is not None:
            cols = cols.sum(dim=dim)
        return cols.to(torch.int64)
    outer = a.unsqueeze(-2) * b.unsqueeze(-3)             # [..., i, j, B]
    if dim is not None:
        outer = outer.sum(dim=dim)
    lead, batch = outer.shape[:-3], outer.shape[-1]
    width = 2 * N_LIMBS
    buf = outer.new_zeros((*lead, N_LIMBS, width, batch))
    buf[..., :N_LIMBS, :] = outer
    skew = buf.reshape(*lead, -1, batch)[..., :N_LIMBS * (width - 1), :]
    cols = outer.new_zeros((*lead, width + 1, batch))
    cols[..., :width - 1, :] = skew.reshape(
        *lead, N_LIMBS, width - 1, batch).sum(dim=-3)
    return cols


def _redc(mf: MontField, cols: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of T (33 non-negative columns below 2^46,
    T / R + 2 p < 2^272) -> (T + m p) / R as 17 normalized limbs, below
    T / R + 2 p.

    m = (T mod R) * (-p^{-1}) mod R over the whole width at once, so
    T + m p is a multiple of R. Only m mod R matters, so T's low half and
    m take two carry passes and no lookahead: m is then held as some
    m + k R with k <= 1 (limbs below 2^17), which costs one more p in the
    bound."""
    k = _limb_consts((mf.pinv, mf.modulus), N_LIMBS, cols.device)
    low = _normalize(cols[..., :N_LIMBS, :], exact=False)
    m = _normalize(_product_cols(low, k[0])[..., :N_LIMBS, :], exact=False)
    full = _normalize(cols + _product_cols(m, k[1]))
    return full[..., N_LIMBS:, :]


def _reduce_sum(mf: MontField, cols: torch.Tensor, bound: int,
                plus: Optional[torch.Tensor], plus_bound: int):
    """(T + plus * R) / R mod p, canonical, for product columns T with
    T / R + p < bound * p (one more p for the relaxed m of _redc)."""
    if plus is not None:
        cols[..., N_LIMBS:2 * N_LIMBS, :] += plus
        bound += plus_bound
    return _reduce(mf, _redc(mf, cols), bound + 1)


def mul(mf: MontField, a: torch.Tensor, b: torch.Tensor,
        plus: Optional[torch.Tensor] = None,
        plus_bound: int = 1) -> torch.Tensor:
    """Montgomery product a*b/R (+ plus) mod p, canonical, for a, b <
    2^256 with at least one of them below p. ``plus`` is a 16-limb value
    below ``plus_bound * p`` whose limbs may exceed 2^16 (a sum of
    canonical values); it joins the product before the one reduction.
    Broadcasts over leading axes and B."""
    # a b < p R, so T/R + p < 2 p
    return _reduce_sum(mf, _product_cols(a, b), 2, plus, plus_bound)


def dot(mf: MontField, a: torch.Tensor, b: torch.Tensor, dim: int,
        plus: Optional[torch.Tensor] = None,
        plus_bound: int = 1) -> torch.Tensor:
    """sum_k a_k*b_k/R (+ plus) mod p over axis ``dim`` (a leading axis
    of both, which have the same rank) with one reduction: the product
    columns are summed before REDC. ``plus`` is as in :func:`mul`."""
    k = max(a.shape[dim], b.shape[dim])
    # canonical inputs: T < k p^2, so T/R + p < (k p / R + 1) p
    bound = k * mf.modulus // (1 << R_BITS) + 2
    return _reduce_sum(mf, _product_cols(a, b, dim), bound, plus,
                       plus_bound)


def to_mont(mf: MontField, x: torch.Tensor) -> torch.Tensor:
    """Any 16-limb value -> canonical Montgomery form of x mod p."""
    r2 = _limb_consts((mf.r2,), N_LIMBS, x.device)[0]
    return mul(mf, x, r2)


def from_mont(mf: MontField, x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical value."""
    cols = torch.cat([x, torch.zeros_like(x), torch.zeros_like(x[..., :1, :])],
                     dim=-2)
    return _reduce(mf, _redc(mf, cols), 3)
