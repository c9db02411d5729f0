"""Pippenger MSM on a resident table of bases (kernel K6).

Counterpart of the JAX package's ``msm/device_v2.py``: host digit and
scalar packing (:func:`signed_digits`, :func:`pack_scalar_words`, with
numpy), :class:`MsmTable` (bases resident on a device, ``msm`` /
``msm_async`` on ints, ``msm_words_async`` on packed words), and
:func:`table_from_bytes`, which turns generators in the params-cache
byte layout (a JAX key's, for one) into a table.

:func:`msm_words` is the wrapper of ``csrc/msm.cu``: on a CUDA table it
launches the kernel (and counts the launch in :data:`launches`, and by
curve name in :data:`launches_by_curve`); on a
CPU table it runs :func:`msm_plain`, a double-and-add over all lanes at
once with the same complete formulas on :mod:`..ops.field`, then a
pairwise tree sum.

Layouts (32-bit words held in ``int32`` tensors, as the Poseidon
wrapper holds its uint32 buffers): the table is ``[n, 2, 8]`` affine
(x, y) in Montgomery form, padded with all-zero rows (never added) to a
power of two of at least 64; scalars are ``[n, 8]`` little-endian words
reduced mod the group order; a result is ``[3, 8]`` projective
(X : Y : Z) in Montgomery form, Z = 0 for the identity.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..curves.weierstrass import Affine, Curve
from ..device import resolve_device
from ..ops import field as F

# The kernel's window width, as ``csrc/msm.cu:kC``: 16 windows of 2^15
# buckets for 256-bit scalars.
C_BITS = 16
N_WIN = 256 // C_BITS
N_BUCKETS = 1 << (C_BITS - 1)
PARAMS_WORDS = 32
R = 1 << 256

# CUDA kernel launches made by msm_words (plain runs are not counted),
# in all and by the table's curve name.
launches = 0
launches_by_curve: Dict[str, int] = {}


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------


def pack_scalar_words(scalars: Sequence[int], order: int) -> np.ndarray:
    """``uint32[n, 8]`` little-endian words of the scalars mod ``order``
    (the kernel's input)."""
    vals = np.array(list(scalars), dtype=object) % order
    return F.ints_to_words(vals).reshape(len(vals), 8)


def _digits12(bytes_le: np.ndarray) -> np.ndarray:
    """[n, 32] uint8 LE -> [n, 22] int32 12-bit digits."""
    b = bytes_le.astype(np.int32)
    cols = []
    for w in range(22):
        off = 12 * w
        byte, sh = off // 8, off % 8
        if byte + 1 < 32:
            d = (b[:, byte] >> sh) | (b[:, byte + 1] << (8 - sh))
        else:
            d = b[:, byte] >> sh
        cols.append(d & 0xFFF)
    return np.stack(cols, axis=1)


def signed_digits(scalars: Sequence[int], order: int, c_bits: int):
    """[n_win, n] int32 bucket ids (0 = skip) and packed (idx<<1)|neg,
    as ``device_v2.signed_digits`` and ``csrc/msm.cu:signed_digit``.

    The TOP window stays unsigned: its digit plus carry fits the
    [0, 2^(c-1)] bucket range for orders below 2^255 (Pallas' top 16-bit
    digit can be exactly 2^14, where a signed fold would need a 17th
    window)."""
    return digits_from_words(pack_scalar_words(scalars, order), c_bits)


def digits_from_words(words: np.ndarray, c_bits: int):
    """:func:`signed_digits` of reduced scalars given as ``uint32[n, 8]``
    words (``c_bits`` 8, 12 or 16; the kernel's is :data:`C_BITS`)."""
    if c_bits not in (8, 12, 16):
        raise ValueError(f"unsupported window width {c_bits}")
    n_win = -(-256 // c_bits)
    n = words.shape[0]
    words = np.ascontiguousarray(words, dtype="<u4")
    if c_bits == 12:
        raw = _digits12(words.view(np.uint8).reshape(n, 32))
    else:
        dt = "<u2" if c_bits == 16 else np.uint8
        raw = words.view(dt).reshape(n, n_win).astype(np.int32)
    buckets = np.zeros((n_win, n), dtype=np.int32)
    negidx = np.zeros((n_win, n), dtype=np.int32)
    idx2 = np.arange(n, dtype=np.int32) << 1
    carry = np.zeros(n, dtype=np.int32)
    half, full = 1 << (c_bits - 1), 1 << c_bits
    for w in range(n_win):
        d = raw[:, w] + carry
        neg = d > half if w < n_win - 1 else np.zeros(n, dtype=bool)
        dd = np.where(neg, d - full, d)
        carry = neg.astype(np.int32)
        buckets[w] = np.abs(dd)
        negidx[w] = idx2 | (dd < 0)
    if int(buckets[n_win - 1].max(initial=0)) > half:
        raise ValueError("top-window digit exceeded the bucket range")
    return buckets, negidx


def points_to_words(points: Sequence[Affine]) -> np.ndarray:
    """Affine points -> canonical ``uint32[n, 2, 8]``; the point at
    infinity becomes an all-zero row, which the MSM skips."""
    coords = [(0, 0) if pt is None else pt for pt in points]
    return F.ints_to_words(coords).reshape(len(points), 2, 8)


# ---------------------------------------------------------------------------
# word tensors <-> limbs
# ---------------------------------------------------------------------------


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """``[M, 8]`` 32-bit words -> ``int64[16, M]`` 16-bit limbs."""
    w64 = w.to(torch.int64) & 0xFFFFFFFF
    m = w64.shape[0]
    return torch.stack([w64 & F.MASK, w64 >> 16], -1).reshape(m, 16).T


def _limbs_to_words(x: torch.Tensor) -> torch.Tensor:
    """``int64[16, M]`` 16-bit limbs -> ``int32[M, 8]`` words."""
    pairs = x.T.reshape(-1, 8, 2)
    return _to_int32(pairs[..., 0] | (pairs[..., 1] << 16))


_TO_MONT_CHUNK = 1 << 17


def _to_mont_words(curve: Curve, canon: torch.Tensor) -> torch.Tensor:
    """Canonical ``[M, 8]`` words -> Montgomery form, on their device."""
    mf = F.mont_field(curve.base)
    out = torch.empty_like(canon)
    for lo in range(0, canon.shape[0], _TO_MONT_CHUNK):
        part = canon[lo:lo + _TO_MONT_CHUNK]
        out[lo:lo + _TO_MONT_CHUNK] = _limbs_to_words(
            F.to_mont(mf, _words_to_limbs(part)))
    return out


_PARAMS: Dict[tuple, torch.Tensor] = {}


def curve_params(curve: Curve, device) -> torch.Tensor:
    """The kernel's ``int32[32]`` curve buffer on ``device`` (cached):
    p, -p^{-1} mod 2^32, 3b as a small signed integer (the kernel
    multiplies by it with additions), 3b and R mod p (Montgomery)."""
    dev = resolve_device(device)
    key = (curve, dev)
    buf = _PARAMS.get(key)
    if buf is None:
        p = curve.p
        b3 = 3 * curve.b % p
        small = b3 if b3 <= p // 2 else b3 - p
        if not 0 < abs(small) < 64:
            raise ValueError(f"{curve.name}: 3b = {small} is not a small "
                             f"constant")
        w = F.ints_to_words([p, b3 * R % p, R % p])
        words = np.zeros(PARAMS_WORDS, dtype=np.uint32)
        words[0:8], words[16:24], words[24:32] = w[0], w[1], w[2]
        words[8] = (-pow(p, -1, 1 << 32)) % (1 << 32)
        words[9] = small % (1 << 32)
        buf = _PARAMS[key] = torch.from_numpy(
            words.view(np.int32).copy()).to(dev)
    return buf


def to_affine(curve: Curve, proj: torch.Tensor) -> Affine:
    """A ``[3, 8]`` projective Montgomery result -> affine or None."""
    x, y, z = F.words_to_ints(proj.cpu().numpy()).tolist()
    p = curve.p
    if z % p == 0:
        return None
    rinv = pow(R, -1, p)
    zinv = pow(z * rinv % p, -1, p)
    return (x * rinv % p * zinv % p, y * rinv % p * zinv % p)


# ---------------------------------------------------------------------------
# table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MsmTable:
    """Montgomery (x, y) rows of a fixed base set, resident on a device
    (commitment generators are long-lived: upload once, reuse)."""

    curve: Curve
    n_points: int             # real bases; rows after them are padding
    rows: torch.Tensor        # int32 [n, 2, 8]

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @staticmethod
    def build(curve: Curve, points: Sequence[Affine],
              device=None) -> "MsmTable":
        return _table(curve, points_to_words(points), device)

    def msm_async(self, scalars: Sequence[int]) -> torch.Tensor:
        """The projective ``[3, 8]`` result on the table's device,
        without waiting for it. Only the scalars' rows go to the MSM
        (the table's first ``len(scalars)``, at least one)."""
        words = pack_scalar_words(scalars, self.curve.order)
        return self.msm_words_async(torch.from_numpy(words.view(np.int32)))

    def msm_words_async(self, words: torch.Tensor) -> torch.Tensor:
        """:meth:`msm_async` of scalars already reduced mod the group
        order, as ``int32[m, 8]`` little-endian words on any device (a
        packed vector's limbs viewed as words, for one): they go to the
        table's device and to :func:`msm_words` with no Python ints."""
        m = words.shape[0]
        if m > self.n_points:
            raise ValueError(f"{m} scalars for a table of {self.n_points} "
                             f"bases")
        if m == 0:
            words = torch.zeros((1, 8), dtype=torch.int32)
        return msm_words(self.prefix(words.shape[0]),
                         words.to(self.device).contiguous())

    def prefix(self, m: int) -> "MsmTable":
        """The table of the first ``m`` rows (a view, no copy)."""
        return MsmTable(self.curve, min(m, self.n_points), self.rows[:m])

    def msm(self, scalars: Sequence[int]) -> Affine:
        """MSM of scalars against the table's first len(scalars) bases."""
        return to_affine(self.curve, self.msm_async(scalars))


def _table(curve: Curve, canon: np.ndarray, device) -> MsmTable:
    dev = resolve_device(device)
    m = canon.shape[0]
    n = max(64, 1 << max(0, m - 1).bit_length())
    rows = torch.zeros((n, 2, 8), dtype=torch.int32, device=dev)
    if m:
        flat = torch.from_numpy(canon.astype("<u4").view(np.int32)
                                .reshape(2 * m, 8)).to(dev)
        rows[:m] = _to_mont_words(curve, flat).reshape(m, 2, 8)
    return MsmTable(curve, m, rows)


def table_from_bytes(curve: Curve, data: bytes, device=None) -> MsmTable:
    """A table from generators in the params-cache byte layout (32-byte
    little-endian x then y per point, as the JAX package's
    ``params_cache._gens_to_bytes`` writes them)."""
    if len(data) % 64:
        raise ValueError("expected 64 bytes per point")
    canon = np.frombuffer(data, dtype="<u4").reshape(-1, 2, 8)
    return _table(curve, canon, device)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _consts(curve: Curve, device):
    p = curve.p
    b3 = F.from_ints([(3 * curve.b % p) * R % p], device)
    one = F.from_ints([R % p], device)
    return F.mont_field(curve.base), b3, one


def _finish(mf, b3, t0, t1, t2, t3, t4, y3):
    """The shared tail of RCB15 Algorithms 7 and 8 from (t0, t1, t2, t3,
    t4, y3) before the multiplications by 3b; products that do not
    depend on each other go in one batched call."""
    t0 = F.add(mf, F.add(mf, t0, t0), t0)
    t2, y3 = F.mul(mf, torch.stack([t2, y3]), b3)
    z3, t1 = F.add(mf, t1, t2), F.sub(mf, t1, t2)
    x3, t2, y3, t1, t0, z3 = F.mul(mf, torch.stack([t4, t3, y3, t1, t0, z3]),
                                   torch.stack([y3, t1, t0, z3, t3, t4]))
    return (F.sub(mf, t2, x3), F.add(mf, t1, y3), F.add(mf, z3, t0))


def ec_add(mf, b3, a, b):
    """RCB15 Algorithm 7 (complete, a = 0) on ``[16, B]`` coordinates."""
    (x1, y1, z1), (x2, y2, z2) = a, b
    s1 = F.add(mf, torch.stack([x1, y1, x1]), torch.stack([y1, z1, z1]))
    s2 = F.add(mf, torch.stack([x2, y2, x2]), torch.stack([y2, z2, z2]))
    t0, t1, t2, m3, m4, m5 = F.mul(mf, torch.stack([x1, y1, z1, *s1]),
                                   torch.stack([x2, y2, z2, *s2]))
    t3, t4, y3 = F.sub(mf, torch.stack([m3, m4, m5]), F.add(
        mf, torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2])))
    return _finish(mf, b3, t0, t1, t2, t3, t4, y3)


def ec_madd(mf, b3, a, x2, y2):
    """RCB15 Algorithm 8 (complete mixed, a = 0): a + (x2, y2, 1)."""
    x1, y1, z1 = a
    t0, t1, m3, m4, m5 = F.mul(
        mf, torch.stack([x1, y1, F.add(mf, x1, y1), z1, z1]),
        torch.stack([x2, y2, F.add(mf, x2, y2), y2, x2]))
    t3 = F.sub(mf, m3, F.add(mf, t0, t1))
    t4, y3 = F.add(mf, torch.stack([m4, m5]), torch.stack([y1, x1]))
    return _finish(mf, b3, t0, t1, z1, t3, t4, y3)


def ec_dbl(mf, b3, a):
    """RCB15 Algorithm 9 (complete doubling, a = 0)."""
    x, y, z = a
    t0, t1, t2, xy = F.mul(mf, torch.stack([y, y, z, x]),
                           torch.stack([y, z, z, y]))
    t2 = F.mul(mf, t2, b3)
    s2 = F.add(mf, torch.stack([t0, t2]), torch.stack([t0, t2]))
    s4 = F.add(mf, s2, torch.stack([s2[0], t2]))         # 4 t0, 3 t2
    z3, y3 = F.add(mf, torch.stack([s4[0], t0]), torch.stack([s4[0], t2]))
    t0 = F.sub(mf, t0, s4[1])
    x3, z3, y3, x3b = F.mul(mf, torch.stack([t2, t1, t0, t0]),
                            torch.stack([z3, z3, y3, xy]))
    y3, x3 = F.add(mf, torch.stack([x3, x3b]), torch.stack([y3, x3b]))
    return x3, y3, z3


PLAIN_WINDOW = 4


@torch.inference_mode()
def msm_plain(curve: Curve, rows: torch.Tensor,
              words: torch.Tensor) -> torch.Tensor:
    """The MSM in plain PyTorch on the tensors' device: every lane's
    k_i * P_i by an MSB-first double-and-add over 4-bit windows (four
    complete doublings, then a complete addition of the lane's multiple
    d P_i, d < 16, from a per-lane table built by complete mixed
    additions), all lanes at once; then a pairwise tree sum. Padding
    rows (all zero) are skipped. Returns the projective ``int32[3, 8]``
    Montgomery result."""
    dev = rows.device
    mf, b3, one = _consts(curve, dev)
    n = rows.shape[0]
    x = _words_to_limbs(rows[:, 0])
    y = _words_to_limbs(rows[:, 1])
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    live = (x != 0).any(0) | (y != 0).any(0)
    w64 = torch.where(live.unsqueeze(1), w64, 0)
    zero = torch.zeros_like(x)
    ident = (zero, one.expand(16, n).clone(), zero)
    top = 0
    for j in range(7, -1, -1):
        m = int(w64[:, j].max())
        if m:
            top = 32 * j + m.bit_length()
            break
    # multiples[d] = d P_i for d < 2^PLAIN_WINDOW: [16, 3, 16, n]
    mult = [ident]
    for _ in range((1 << PLAIN_WINDOW) - 1):
        mult.append(ec_madd(mf, b3, mult[-1], x, y))
    table = torch.stack([torch.stack(m) for m in mult])
    lanes = torch.arange(n, device=dev)
    acc = ident
    for win in range(-(-top // PLAIN_WINDOW) - 1, -1, -1):
        for _ in range(PLAIN_WINDOW):
            acc = ec_dbl(mf, b3, acc)
        bit = PLAIN_WINDOW * win
        d = (w64[:, bit // 32] >> (bit % 32)) & ((1 << PLAIN_WINDOW) - 1)
        acc = ec_add(mf, b3, acc, tuple(table[d, :, :, lanes]
                                        .permute(1, 2, 0)))
    while acc[0].shape[-1] > 1:
        if acc[0].shape[-1] % 2:
            ident = (zero[:, :1], one, zero[:, :1])
            acc = tuple(torch.cat([a, i], -1) for a, i in zip(acc, ident))
        acc = ec_add(mf, b3, tuple(a[:, 0::2] for a in acc),
                     tuple(a[:, 1::2] for a in acc))
    return torch.cat([_limbs_to_words(a) for a in acc], 0)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """``csrc/msm.cu``, built at first use."""
    global _LIB
    if _LIB is None:
        from .. import native
        lib = native.load("msm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lurk_msm.argtypes = [p, p, ll, p, p, p, p]
        lib.lurk_msm.restype = i
        lib.lurk_msm_workspace_bytes.argtypes = [ll]
        lib.lurk_msm_workspace_bytes.restype = ll
        _LIB = lib
    return _LIB


def _msm_cuda(table: MsmTable, words: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _library()
    dev = table.device
    nbytes = lib.lurk_msm_workspace_bytes(table.n)
    if nbytes < 0:
        raise ValueError(f"unsupported MSM size n={table.n}")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((3, 8), dtype=torch.int32, device=dev)
    params = curve_params(table.curve, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lurk_msm(
            ctypes.c_void_p(table.rows.data_ptr()),
            ctypes.c_void_p(words.data_ptr()), table.n,
            ctypes.c_void_p(params.data_ptr()),
            ctypes.c_void_p(workspace.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"msm kernel launch failed: CUDA error {err}")
    launches += 1
    name = table.curve.name
    launches_by_curve[name] = launches_by_curve.get(name, 0) + 1
    return out


def msm_words(table: MsmTable, words: torch.Tensor) -> torch.Tensor:
    """The MSM of ``words`` (``int32[table.n, 8]``, reduced scalars, on
    the table's device) against the table: projective ``int32[3, 8]``.
    CUDA tables go through the kernel, CPU tables through the plain
    version; any other device raises."""
    if words.dtype != torch.int32 or tuple(words.shape) != (table.n, 8) \
            or words.device != table.device or not words.is_contiguous():
        raise ValueError(f"expected contiguous int32[{table.n}, 8] scalar "
                         f"words on {table.device}, got {words.dtype}"
                         f"{list(words.shape)} on {words.device}")
    if table.device.type == "cuda":
        return _msm_cuda(table, words)
    if table.device.type == "cpu":
        return msm_plain(table.curve, table.rows, words)
    raise ValueError(f"unsupported device {table.device}")
