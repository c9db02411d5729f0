"""Batched Poseidon with the sparse partial-round schedule.

Counterpart of the JAX package's ``poseidon/pallas_nib12_opt.py``
(``build_pallas_nib12_opt_hasher``, the default hydration kernel) and of
``poseidon/kernel.py``'s host API (``hash_batch``, ``hash_batch_padded``).

:func:`poseidon_hash` takes ``int32[arity, 16, B]`` canonical 16-bit
limbs and returns the digests as ``int32[16, B]``, the JAX builders'
layout. On a CUDA tensor it launches ``csrc/poseidon.cu`` (one thread
per hash, the state in registers); on a CPU tensor it runs
:func:`poseidon_hash_plain`, the same schedule on :mod:`..ops.field`.
Both read one constant buffer: by default the one cached per (field,
arity, device) by :func:`constants`, or one the caller passes as
``consts`` (:func:`constants_from_numpy` builds it from another
implementation's constants). It holds the ``opt_spec`` keys and matrices
in Montgomery form (8 little-endian 32-bit words per element) behind a
header holding p, R^2 mod p and -p^{-1} mod 2^32.

Schedule (add-after form, ``opt_spec.hash_preimage_opt``): the state
[tag, x...] gets ``pre_keys``; each round applies the S-box (all
elements in full rounds, element 0 in partial rounds), its matrix, then
``post_keys[r]``. The matrices are the dense MDS in full rounds,
``sparse[0]`` in round RF/2-1, ``sparse[k+1]`` in partial round k and
the dense ``pre_sparse`` in the last partial round. The digest is s[1].
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fields import FieldSpec
from ..ops import field as F
from .opt_spec import opt_poseidon_spec

# CUDA kernel launches made by poseidon_hash (plain runs are not counted).
launches = 0

HEADER_WORDS = 24      # p[8], r2[8], pinv, padding to a whole element


@dataclasses.dataclass(frozen=True)
class Layout:
    """Element offsets (after the header) of each part of the buffer."""

    t: int
    rf: int
    rp: int

    @property
    def n_rounds(self) -> int:
        return self.rf + self.rp

    @property
    def pre(self) -> int:
        return 0

    @property
    def post(self) -> int:
        return self.t

    @property
    def mds(self) -> int:
        return self.post + self.n_rounds * self.t

    @property
    def tail(self) -> int:
        return self.mds + self.t * self.t

    @property
    def sparse(self) -> int:
        return self.tail + self.t * self.t

    @property
    def n_elems(self) -> int:
        return self.sparse + self.rp * (2 * self.t - 1)


def _words(values: Sequence[int]) -> np.ndarray:
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4")


def _assemble(field: FieldSpec, tag: int, pre_keys, post_keys, mds_col,
              pre_sparse, sparse_rows) -> np.ndarray:
    """The buffer as ``uint32[HEADER_WORDS + 8 * n_elems]``.

    ``sparse_rows[k]`` is ``[m00, *w, *v_hat]`` of ``sparse[k]``."""
    mf = F.mont_field(field)
    p = field.modulus
    t = len(pre_keys)
    pre = [((tag if i == 0 else 0) + pre_keys[i]) % p for i in range(t)]
    elems = (pre + [v for row in post_keys for v in row]
             + [v for row in mds_col for v in row]
             + [v for row in pre_sparse for v in row]
             + [v for row in sparse_rows for v in row])
    lay = Layout(t, len(post_keys) - len(sparse_rows), len(sparse_rows))
    if len(elems) != lay.n_elems or lay.rf < 2:
        raise ValueError("inconsistent Poseidon constant shapes")
    header = np.zeros(HEADER_WORDS, dtype=np.uint32)
    header[0:8] = _words([p])
    header[8:16] = _words([mf.r2])
    header[16] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    body = _words([mf.to_mont_int(v % p) for v in elems])
    return np.concatenate([header, body])


@lru_cache(maxsize=None)
def _host_constants(field: FieldSpec, arity: int) -> np.ndarray:
    o = opt_poseidon_spec(field, arity)
    return _assemble(
        field, o.spec.domain_tag, o.pre_keys, o.post_keys, o.mds_col,
        o.pre_sparse, [[s.m00, *s.w, *s.v_hat] for s in o.sparse])


_DEVICE_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _to_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def constants(field: FieldSpec, arity: int, device=None) -> torch.Tensor:
    """The cached ``int32`` constant buffer for (field, arity) on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    key = (field, arity, dev)
    buf = _DEVICE_CONSTANTS.get(key)
    if buf is None:
        buf = _DEVICE_CONSTANTS[key] = _to_tensor(
            _host_constants(field, arity), dev)
    return buf


def constants_from_numpy(field: FieldSpec, arrays: Dict[str, np.ndarray],
                         device=None) -> torch.Tensor:
    """The constant buffer from another implementation's constants, given
    as canonical 16-bit limbs (``uint32[..., 16]``), on ``device``
    (default ``cuda``); :func:`poseidon_hash` takes it as ``consts``:

    - ``domain_tag`` [16] and ``mds`` [t, t, 16] from ``poseidon_spec``
      (``mds`` in its own orientation: out[j] = sum_i mds[i][j] s[i]);
    - ``pre_keys`` [t, 16], ``post_keys`` [RF+RP, t, 16], ``pre_sparse``
      [t, t, 16], ``sparse_m00`` [RP, 16], ``sparse_w`` and
      ``sparse_v_hat`` [RP, t-1, 16] from ``opt_poseidon_spec``.

    The round constants enter only through ``pre_keys`` and
    ``post_keys``."""
    def ints(name):
        a = np.asarray(arrays[name])
        if a.shape[-1] != F.N_LIMBS or a.min() < 0 or a.max() > F.MASK:
            raise ValueError(f"{name}: expected 16-bit limbs on the last axis")
        flat = F.limbs_to_ints(a.reshape(-1, F.N_LIMBS))
        return np.array(flat, dtype=object).reshape(a.shape[:-1])

    mds = ints("mds")
    t = mds.shape[0]
    m00, w, v_hat = ints("sparse_m00"), ints("sparse_w"), ints("sparse_v_hat")
    sparse_rows = [[m00[k], *w[k], *v_hat[k]] for k in range(len(m00))]
    words = _assemble(
        field, int(ints("domain_tag")), list(ints("pre_keys")),
        ints("post_keys").tolist(),
        [[mds[j][i] for j in range(t)] for i in range(t)],
        ints("pre_sparse").tolist(), sparse_rows)
    return _to_tensor(words, resolve_device(device))


def _layout(field: FieldSpec, arity: int) -> Layout:
    spec = opt_poseidon_spec(field, arity).spec
    return Layout(spec.width, spec.full_rounds, spec.partial_rounds)


def _buffer(field: FieldSpec, arity: int, device: torch.device,
            consts: Optional[torch.Tensor]) -> torch.Tensor:
    """``consts`` after checking it fits (field, arity) on ``device``, or
    the cached buffer when it is None."""
    if consts is None:
        return constants(field, arity, device)
    n = HEADER_WORDS + 8 * _layout(field, arity).n_elems
    if consts.dtype != torch.int32 or tuple(consts.shape) != (n,) or \
            consts.device != device or not consts.is_contiguous():
        raise ValueError(f"expected a contiguous int32[{n}] constant buffer "
                         f"on {device}, got {consts.dtype}"
                         f"{list(consts.shape)} on {consts.device}")
    return consts


def _check(arity: int, x: torch.Tensor) -> None:
    if arity not in (3, 4, 6, 8):
        raise ValueError(f"unsupported arity {arity}")
    if x.dtype != torch.int32 or x.dim() != 3 or \
            tuple(x.shape[:2]) != (arity, F.N_LIMBS):
        raise ValueError(f"expected int32[{arity}, 16, B], got "
                         f"{x.dtype}{list(x.shape)}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


@torch.inference_mode()
def poseidon_hash_plain(field: FieldSpec, arity: int, x: torch.Tensor,
                        consts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, on ``x``'s device. Each
    mix row and its ``post_keys`` addend take one reduction."""
    _check(arity, x)
    mf = F.mont_field(field)
    lay = _layout(field, arity)
    t, rf_half, rp = lay.t, lay.rf // 2, lay.rp
    words = _buffer(field, arity, x.device, consts)[HEADER_WORDS:]
    # uint32 words -> 16-bit limbs: [n_elems, 16, 1]
    w = words.to(torch.int64) & 0xFFFFFFFF
    k = torch.stack([w & F.MASK, w >> 16], dim=-1).reshape(lay.n_elems, 16)
    k = k.unsqueeze(-1)

    def elems(off, n):
        return k[off:off + n]

    mds = elems(lay.mds, t * t).reshape(t, t, 16, 1)
    tail = elems(lay.tail, t * t).reshape(t, t, 16, 1)

    def post(r):
        return elems(lay.post + r * t, t)

    def sbox(v):
        v2 = F.mul(mf, v, v)
        v4 = F.mul(mf, v2, v2)
        return F.mul(mf, v4, v)

    def dense(m, s, r):
        return F.dot(mf, m, s.unsqueeze(0), dim=1, plus=post(r))

    def sparse(kk, s, r):
        row = elems(lay.sparse + kk * (2 * t - 1), 2 * t - 1)
        keys = post(r)
        new0 = F.dot(mf, row[:t], s, dim=0, plus=keys[0])
        rest = F.mul(mf, row[t:], s[:1], plus=s[1:] + keys[1:],
                     plus_bound=2)
        return torch.cat([new0.unsqueeze(0), rest], dim=0)

    def with_sbox0(s):
        return torch.cat([sbox(s[:1]), s[1:]], dim=0)

    b = x.shape[-1]
    inputs = F.to_mont(mf, x.to(torch.int64))
    s = torch.cat([torch.zeros((1, 16, b), dtype=torch.int64,
                               device=x.device), inputs], dim=0)
    s = F.add(mf, s, elems(lay.pre, t))
    for r in range(rf_half - 1):
        s = dense(mds, sbox(s), r)
    s = sparse(0, sbox(s), rf_half - 1)
    for kk in range(rp - 1):
        s = sparse(kk + 1, with_sbox0(s), rf_half + kk)
    s = dense(tail, with_sbox0(s), rf_half + rp - 1)
    for r in range(rf_half + rp, lay.n_rounds):
        s = dense(mds, sbox(s), r)
    return F.from_mont(mf, s[1]).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """``csrc/poseidon.cu``, built at first use."""
    global _LIB
    if _LIB is None:
        from .. import native
        lib = native.load("poseidon")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lurk_poseidon_sparse.argtypes = [p, p, p, i, i, i,
                                             ctypes.c_longlong, p]
        lib.lurk_poseidon_sparse.restype = i
        _LIB = lib
    return _LIB


def _poseidon_cuda(field: FieldSpec, arity: int, x: torch.Tensor,
                   consts: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    if not x.is_contiguous():
        raise ValueError("poseidon_hash: x must be contiguous")
    lib = _library()
    lay = _layout(field, arity)
    buf = _buffer(field, arity, x.device, consts)
    b = x.shape[-1]
    out = torch.empty((F.N_LIMBS, b), dtype=torch.int32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lurk_poseidon_sparse(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(buf.data_ptr()), arity, lay.rf, lay.rp, b,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"poseidon kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def poseidon_hash(field: FieldSpec, arity: int, x: torch.Tensor,
                  consts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Digests ``int32[16, B]`` of ``x: int32[arity, 16, B]`` (canonical
    16-bit limbs). CUDA tensors go through the kernel, CPU tensors
    through the plain version; any other device raises. ``consts`` is a
    constant buffer on ``x``'s device (:func:`constants_from_numpy`),
    by default the cached :func:`constants`."""
    _check(arity, x)
    if x.device.type == "cuda":
        return _poseidon_cuda(field, arity, x, consts)
    if x.device.type == "cpu":
        return poseidon_hash_plain(field, arity, x, consts)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


def preimages_to_tensor(field: FieldSpec, arity: int,
                        preimages_ints, device) -> torch.Tensor:
    """Lists of ``arity`` ints -> ``int32[arity, 16, B]`` on ``device``."""
    p = field.modulus
    vals: List[int] = []
    for pre in preimages_ints:
        if len(pre) != arity:
            raise ValueError(f"preimage of length {len(pre)}, "
                             f"expected {arity}")
        vals.extend(v % p for v in pre)
    limbs = F.ints_to_limbs(vals).reshape(len(preimages_ints), arity, 16)
    arr = np.ascontiguousarray(limbs.transpose(1, 2, 0), dtype=np.int32)
    return torch.from_numpy(arr).to(device)


def hash_batch(field: FieldSpec, arity: int, preimages_ints,
               device=None) -> list:
    """Lists of ``arity`` ints -> digests as Python ints, hashed as one
    batch on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if len(preimages_ints) == 0:
        return []
    x = preimages_to_tensor(field, arity, preimages_ints, dev)
    out = poseidon_hash(field, arity, x)
    return F.limbs_to_ints(out.cpu().numpy().T)


def hash_batch_padded(field: FieldSpec, arity: int, preimages_ints,
                      device=None) -> list:
    """Same as :func:`hash_batch`. The JAX package pads batches to a few
    sizes to bound recompilation; the CUDA kernel takes any batch."""
    return hash_batch(field, arity, preimages_ints, device)
