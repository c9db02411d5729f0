"""Batched Poseidon with the sparse partial-round schedule.

Counterpart of the JAX package's ``poseidon/pallas_nib12_opt.py``
(``build_pallas_nib12_opt_hasher``, the default hydration kernel) and of
``poseidon/kernel.py``'s host API (``hash_batch``, ``hash_batch_padded``).

:func:`poseidon_hash` takes ``int32[arity, 16, B]`` canonical 16-bit
limbs and returns the digests as ``int32[16, B]``, the JAX builders'
layout. On a CUDA tensor it launches ``csrc/poseidon.cu`` (a lane group
per hash for small batches, one thread per hash from
:func:`thread_from`'s batch); on a CPU tensor it runs
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

The dense schedule (``poseidon_hash_dense``, kernel K2 in
``csrc/poseidon_dense.cu``, counterpart of ``poseidon/pallas_nib12.py``)
computes the same digests the spec's way: each round adds the round
constants to every element, applies the S-box (all elements in full
rounds, element 0 in partial rounds) and the full MDS. Its buffer
(:func:`dense_constants`) holds the round constants, the domain tag
folded into the first, and the MDS, in Montgomery form behind the same
header. The prover's sharded hydration (``parallel/sharding.py``) runs
it per shard.

The folded schedule (``poseidon_hash_folded``, kernel ``csrc/
poseidon_folded.cu``, counterpart of ``poseidon/pallas_nib.py:
build_pallas_nib_opt_hasher`` and ``pallas_mxu.py:
build_pallas_mxu_opt_hasher``) runs the full rounds the dense way and the
partial span from the tables of :mod:`.partial_opt`: each partial
round's S-box input is ``u_r = alpha_r . s_a + beta_r + sum_{q<r}
gamma_{r-1-q} delta_q`` over the state ``s_a`` entering the span and the
earlier S-box outputs ``delta_q``, and the state leaving the span is
``A s_a + B + W delta``. Its buffer (:func:`folded_constants`) holds the
full rounds' constants (the domain tag folded into the first), the MDS
and the six tables, in Montgomery form behind the same header.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fields import FieldSpec
from ..ops import field as F
from .opt_spec import opt_poseidon_spec
from .partial_opt import partial_schedule
from .spec import poseidon_spec

# CUDA kernel launches made by poseidon_hash, poseidon_hash_dense and
# poseidon_hash_folded (plain runs are not counted).
launches = 0
dense_launches = 0
folded_launches = 0

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


@dataclasses.dataclass(frozen=True)
class DenseLayout:
    """Element offsets (after the header) of the dense buffer."""

    t: int
    rf: int
    rp: int

    @property
    def n_rounds(self) -> int:
        return self.rf + self.rp

    @property
    def mds(self) -> int:
        return self.n_rounds * self.t

    @property
    def n_elems(self) -> int:
        return self.mds + self.t * self.t


@dataclasses.dataclass(frozen=True)
class FoldedLayout:
    """Element offsets (after the header) of the folded buffer."""

    t: int
    rf: int
    rp: int

    @property
    def mds(self) -> int:
        return self.rf * self.t

    @property
    def alpha(self) -> int:
        return self.mds + self.t * self.t

    @property
    def beta(self) -> int:
        return self.alpha + self.rp * self.t

    @property
    def gamma(self) -> int:
        return self.beta + self.rp

    @property
    def a_mat(self) -> int:
        return self.gamma + self.rp

    @property
    def b_vec(self) -> int:
        return self.a_mat + self.t * self.t

    @property
    def w_mat(self) -> int:
        return self.b_vec + self.t

    @property
    def n_elems(self) -> int:
        return self.w_mat + self.t * self.rp


def _words(values: Sequence[int]) -> np.ndarray:
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4")


def _with_header(field: FieldSpec, elems: Sequence[int]) -> np.ndarray:
    """``uint32[HEADER_WORDS + 8 * len(elems)]``: p, R^2 mod p and
    -p^{-1} mod 2^32, then the elements in Montgomery form."""
    mf = F.mont_field(field)
    p = field.modulus
    header = np.zeros(HEADER_WORDS, dtype=np.uint32)
    header[0:8] = _words([p])
    header[8:16] = _words([mf.r2])
    header[16] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    body = _words([mf.to_mont_int(v % p) for v in elems])
    return np.concatenate([header, body])


def _assemble(field: FieldSpec, tag: int, pre_keys, post_keys, mds_col,
              pre_sparse, sparse_rows) -> np.ndarray:
    """The buffer as ``uint32[HEADER_WORDS + 8 * n_elems]``.

    ``sparse_rows[k]`` is ``[m00, *w, *v_hat]`` of ``sparse[k]``."""
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
    return _with_header(field, elems)


def _assemble_dense(field: FieldSpec, tag: int, round_constants,
                    mds) -> np.ndarray:
    """The dense buffer: ``round_constants`` in generation order with
    ``tag`` folded into the first, then the MDS row by output (element
    (j, i) is ``mds[i][j]``, neptune's orientation)."""
    t = len(mds)
    rcs = [int(v) for v in round_constants]
    if t < 2 or len(rcs) % t or any(len(row) != t for row in mds):
        raise ValueError("inconsistent Poseidon constant shapes")
    rcs[0] = (rcs[0] + tag) % field.modulus
    return _with_header(
        field, rcs + [mds[i][j] for j in range(t) for i in range(t)])


def _assemble_folded(field: FieldSpec, tag: int, round_constants, mds,
                     alpha, beta, gamma, a_mat, b_vec, w_mat) -> np.ndarray:
    """The folded buffer: the full rounds' constants (``round_constants``
    in generation order, the partial rounds' dropped: they live in
    ``beta`` and ``b_vec``) with ``tag`` folded into the first, the MDS
    row by output (element (j, i) is ``mds[i][j]``), then ``alpha``
    [rp][t], ``beta`` [rp], ``gamma`` [rp], ``a_mat`` [t][t], ``b_vec``
    [t] and ``w_mat`` [t][rp] of :func:`.partial_opt.partial_schedule`."""
    t, rp = len(mds), len(beta)
    rcs = [int(v) for v in round_constants]
    if t < 2 or len(rcs) % t or any(len(row) != t for row in mds):
        raise ValueError("inconsistent Poseidon constant shapes")
    rf = len(rcs) // t - rp
    lay = FoldedLayout(t, rf, rp)
    if rf < 2 or rf % 2 or len(gamma) != rp or len(b_vec) != t or \
            any(len(row) != t for row in alpha) or len(alpha) != rp or \
            any(len(row) != t for row in a_mat) or len(a_mat) != t or \
            any(len(row) != rp for row in w_mat) or len(w_mat) != t:
        raise ValueError("inconsistent folded Poseidon table shapes")
    rcs[0] = (rcs[0] + tag) % field.modulus
    half = rf // 2
    full = rcs[:half * t] + rcs[(half + rp) * t:]
    elems = (full + [mds[i][j] for j in range(t) for i in range(t)]
             + [v for row in alpha for v in row] + list(beta) + list(gamma)
             + [v for row in a_mat for v in row] + list(b_vec)
             + [v for row in w_mat for v in row])
    assert len(elems) == lay.n_elems
    return _with_header(field, elems)


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


def _limb_ints(arrays: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """``arrays[name]`` (canonical 16-bit limbs on the last axis) as an
    object array of ints."""
    a = np.asarray(arrays[name])
    if a.shape[-1] != F.N_LIMBS or a.min() < 0 or a.max() > F.MASK:
        raise ValueError(f"{name}: expected 16-bit limbs on the last axis")
    flat = F.limbs_to_ints(a.reshape(-1, F.N_LIMBS))
    return np.array(flat, dtype=object).reshape(a.shape[:-1])


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
        return _limb_ints(arrays, name)

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


@lru_cache(maxsize=None)
def _host_dense_constants(field: FieldSpec, arity: int) -> np.ndarray:
    spec = poseidon_spec(field, arity)
    return _assemble_dense(field, spec.domain_tag, spec.round_constants,
                           spec.mds)


def dense_constants(field: FieldSpec, arity: int,
                    device=None) -> torch.Tensor:
    """The cached ``int32`` dense-schedule buffer for (field, arity) on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    key = ("dense", field, arity, dev)
    buf = _DEVICE_CONSTANTS.get(key)
    if buf is None:
        buf = _DEVICE_CONSTANTS[key] = _to_tensor(
            _host_dense_constants(field, arity), dev)
    return buf


def dense_constants_from_numpy(field: FieldSpec,
                               arrays: Dict[str, np.ndarray],
                               device=None) -> torch.Tensor:
    """The dense buffer from another implementation's constants, given
    as canonical 16-bit limbs (``uint32[..., 16]``) from its
    ``poseidon_spec``: ``domain_tag`` [16], ``round_constants``
    [(RF+RP) t, 16] in generation order and ``mds`` [t, t, 16] in its own
    orientation (out[j] = sum_i mds[i][j] s[i]); on ``device`` (default
    ``cuda``). :func:`poseidon_hash_dense` takes it as ``consts``."""
    words = _assemble_dense(
        field, int(_limb_ints(arrays, "domain_tag")),
        _limb_ints(arrays, "round_constants").tolist(),
        _limb_ints(arrays, "mds").tolist())
    return _to_tensor(words, resolve_device(device))


@lru_cache(maxsize=None)
def _host_folded_constants(field: FieldSpec, arity: int) -> np.ndarray:
    spec = poseidon_spec(field, arity)
    sc = partial_schedule(field, arity)
    return _assemble_folded(field, spec.domain_tag, spec.round_constants,
                            spec.mds, sc.alpha, sc.beta, sc.gamma, sc.a_mat,
                            sc.b_vec, sc.w_mat)


def folded_constants(field: FieldSpec, arity: int,
                     device=None) -> torch.Tensor:
    """The cached ``int32`` folded-schedule buffer for (field, arity) on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    key = ("folded", field, arity, dev)
    buf = _DEVICE_CONSTANTS.get(key)
    if buf is None:
        buf = _DEVICE_CONSTANTS[key] = _to_tensor(
            _host_folded_constants(field, arity), dev)
    return buf


def folded_constants_from_numpy(field: FieldSpec,
                                arrays: Dict[str, np.ndarray],
                                device=None) -> torch.Tensor:
    """The folded buffer from another implementation's constants, given
    as canonical 16-bit limbs (``uint32[..., 16]``): ``domain_tag`` [16],
    ``round_constants`` [(RF+RP) t, 16] and ``mds`` [t, t, 16] (its own
    orientation) from its ``poseidon_spec``, and its ``partial_schedule``
    tables ``alpha`` [RP, t, 16], ``beta`` and ``gamma`` [RP, 16],
    ``a_mat`` [t, t, 16], ``b_vec`` [t, 16] and ``w_mat`` [t, RP, 16];
    on ``device`` (default ``cuda``). :func:`poseidon_hash_folded` takes
    it as ``consts``."""
    def ints(name):
        return _limb_ints(arrays, name).tolist()

    words = _assemble_folded(
        field, int(_limb_ints(arrays, "domain_tag")), ints("round_constants"),
        ints("mds"), ints("alpha"), ints("beta"), ints("gamma"),
        ints("a_mat"), ints("b_vec"), ints("w_mat"))
    return _to_tensor(words, resolve_device(device))


def _layout(field: FieldSpec, arity: int) -> Layout:
    spec = opt_poseidon_spec(field, arity).spec
    return Layout(spec.width, spec.full_rounds, spec.partial_rounds)


def _dense_layout(field: FieldSpec, arity: int) -> DenseLayout:
    spec = poseidon_spec(field, arity)
    return DenseLayout(spec.width, spec.full_rounds, spec.partial_rounds)


def _folded_layout(field: FieldSpec, arity: int) -> FoldedLayout:
    spec = poseidon_spec(field, arity)
    return FoldedLayout(spec.width, spec.full_rounds, spec.partial_rounds)


def _buffer(field: FieldSpec, arity: int, device: torch.device,
            consts: Optional[torch.Tensor]) -> torch.Tensor:
    """``consts`` after checking it fits (field, arity) on ``device``, or
    the cached buffer when it is None."""
    if consts is None:
        return constants(field, arity, device)
    return _checked(consts, _layout(field, arity).n_elems, device)


def _dense_buffer(field: FieldSpec, arity: int, device: torch.device,
                  consts: Optional[torch.Tensor]) -> torch.Tensor:
    """As :func:`_buffer`, for the dense schedule."""
    if consts is None:
        return dense_constants(field, arity, device)
    return _checked(consts, _dense_layout(field, arity).n_elems, device)


def _folded_buffer(field: FieldSpec, arity: int, device: torch.device,
                   consts: Optional[torch.Tensor]) -> torch.Tensor:
    """As :func:`_buffer`, for the folded schedule."""
    if consts is None:
        return folded_constants(field, arity, device)
    return _checked(consts, _folded_layout(field, arity).n_elems, device)


def _checked(consts: torch.Tensor, n_elems: int,
             device: torch.device) -> torch.Tensor:
    n = HEADER_WORDS + 8 * n_elems
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


def _elements(words: torch.Tensor, n_elems: int) -> torch.Tensor:
    """The buffer's elements (after the header) as 16-bit limbs:
    ``int64[n_elems, 16, 1]``."""
    w = words[HEADER_WORDS:].to(torch.int64) & 0xFFFFFFFF
    k = torch.stack([w & F.MASK, w >> 16], dim=-1).reshape(n_elems, 16)
    return k.unsqueeze(-1)


def _sbox(mf: F.MontField, v: torch.Tensor) -> torch.Tensor:
    v2 = F.mul(mf, v, v)
    v4 = F.mul(mf, v2, v2)
    return F.mul(mf, v4, v)


def _inputs(mf: F.MontField, x: torch.Tensor) -> torch.Tensor:
    """``[arity, 16, B]`` canonical limbs -> the initial state
    ``[t, 16, B]`` in Montgomery form with slot 0 (the tag's, folded into
    the constants) at 0."""
    b = x.shape[-1]
    inputs = F.to_mont(mf, x.to(torch.int64))
    return torch.cat([torch.zeros((1, 16, b), dtype=torch.int64,
                                  device=x.device), inputs], dim=0)


@torch.inference_mode()
def poseidon_hash_plain(field: FieldSpec, arity: int, x: torch.Tensor,
                        consts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, on ``x``'s device. Each
    mix row and its ``post_keys`` addend take one reduction."""
    _check(arity, x)
    mf = F.mont_field(field)
    lay = _layout(field, arity)
    t, rf_half, rp = lay.t, lay.rf // 2, lay.rp
    k = _elements(_buffer(field, arity, x.device, consts), lay.n_elems)

    def elems(off, n):
        return k[off:off + n]

    mds = elems(lay.mds, t * t).reshape(t, t, 16, 1)
    tail = elems(lay.tail, t * t).reshape(t, t, 16, 1)

    def post(r):
        return elems(lay.post + r * t, t)

    def sbox(v):
        return _sbox(mf, v)

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

    s = F.add(mf, _inputs(mf, x), elems(lay.pre, t))
    for r in range(rf_half - 1):
        s = dense(mds, sbox(s), r)
    s = sparse(0, sbox(s), rf_half - 1)
    for kk in range(rp - 1):
        s = sparse(kk + 1, with_sbox0(s), rf_half + kk)
    s = dense(tail, with_sbox0(s), rf_half + rp - 1)
    for r in range(rf_half + rp, lay.n_rounds):
        s = dense(mds, sbox(s), r)
    return F.from_mont(mf, s[1]).to(torch.int32)


@torch.inference_mode()
def poseidon_hash_dense_plain(field: FieldSpec, arity: int, x: torch.Tensor,
                              consts: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """K2's dense schedule in plain PyTorch, on ``x``'s device: per
    round the constants, the S-box (all elements in full rounds, element
    0 in partial rounds) and the full MDS as one dot product per row."""
    _check(arity, x)
    mf = F.mont_field(field)
    lay = _dense_layout(field, arity)
    t, rf_half = lay.t, lay.rf // 2
    k = _elements(_dense_buffer(field, arity, x.device, consts),
                  lay.n_elems)
    mds = k[lay.mds:].reshape(t, t, 16, 1)            # [out j, in i]
    s = _inputs(mf, x)
    for r in range(lay.n_rounds):
        s = F.add(mf, s, k[r * t:(r + 1) * t])
        if r < rf_half or r >= rf_half + lay.rp:
            s = _sbox(mf, s)
        else:
            s = torch.cat([_sbox(mf, s[:1]), s[1:]], dim=0)
        s = F.dot(mf, mds, s.unsqueeze(0), dim=1)
    return F.from_mont(mf, s[1]).to(torch.int32)


@torch.inference_mode()
def poseidon_hash_folded_plain(field: FieldSpec, arity: int,
                               x: torch.Tensor,
                               consts: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The folded schedule in plain PyTorch, on ``x``'s device: full
    rounds as in :func:`poseidon_hash_dense_plain`; partial round r's
    S-box input is one dot product of ``[alpha_r, gamma_{r-1}, ...,
    gamma_0]`` with ``[s_a, delta_0, ..., delta_{r-1}]`` plus ``beta_r``;
    the state leaving the span is one dot product per row of ``[A | W]``
    with ``[s_a, delta]`` plus ``B``."""
    _check(arity, x)
    mf = F.mont_field(field)
    lay = _folded_layout(field, arity)
    t, half, rp = lay.t, lay.rf // 2, lay.rp
    k = _elements(_folded_buffer(field, arity, x.device, consts),
                  lay.n_elems)
    mds = k[lay.mds:lay.alpha].reshape(t, t, 16, 1)   # [out j, in i]
    alpha = k[lay.alpha:lay.beta].reshape(rp, t, 16, 1)
    beta, gamma = k[lay.beta:lay.gamma], k[lay.gamma:lay.a_mat]
    a_mat = k[lay.a_mat:lay.b_vec].reshape(t, t, 16, 1)
    b_vec = k[lay.b_vec:lay.w_mat]
    w_mat = k[lay.w_mat:].reshape(t, rp, 16, 1)

    def full_round(s, r):
        s = _sbox(mf, F.add(mf, s, k[r * t:(r + 1) * t]))
        return F.dot(mf, mds, s.unsqueeze(0), dim=1)

    s = _inputs(mf, x)
    for r in range(half):
        s = full_round(s, r)
    deltas = []
    for r in range(rp):
        coeff = torch.cat([alpha[r], gamma[:r].flip(0)], dim=0)
        u = F.dot(mf, coeff, torch.cat([s, *deltas], dim=0), dim=0,
                  plus=beta[r])
        deltas.append(_sbox(mf, u.unsqueeze(0)))
    vals = torch.cat([s, *deltas], dim=0)
    s = torch.stack([
        F.dot(mf, torch.cat([a_mat[i], w_mat[i]], dim=0), vals, dim=0,
              plus=b_vec[i]) for i in range(t)])
    for r in range(half, lay.rf):
        s = full_round(s, r)
    return F.from_mont(mf, s[1]).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


# source in csrc/ -> its C entry point
_ENTRY = {"poseidon": "lurk_poseidon_sparse",
          "poseidon_dense": "lurk_poseidon_dense",
          "poseidon_folded": "lurk_poseidon_folded"}
_FNS: Dict[str, Callable] = {}


def _entry(name: str) -> Callable:
    """The C entry point of ``csrc/<name>.cu``, built at first use."""
    fn = _FNS.get(name)
    if fn is None:
        from .. import native
        fn = getattr(native.load(name), _ENTRY[name])
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, p]
        fn.restype = i
        _FNS[name] = fn
    return fn


def thread_from(name: str) -> int:
    """The batch from which kernel ``name`` (``"poseidon"`` or
    ``"poseidon_dense"``) runs one thread per hash; smaller batches run
    a lane group per hash. A constant of the kernel's source, read from
    its library (built at first use)."""
    from .. import native
    fn = getattr(native.load(name), _ENTRY[name] + "_thread_from")
    fn.argtypes = []
    fn.restype = ctypes.c_longlong
    return int(fn())


def _launch(name: str, arity: int, rf: int, rp: int, x: torch.Tensor,
            buf: torch.Tensor) -> torch.Tensor:
    """One launch of kernel ``name`` on ``x``'s device and current
    stream; raises on a CUDA error."""
    if not x.is_contiguous():
        raise ValueError("poseidon: x must be contiguous")
    fn = _entry(name)
    b = x.shape[-1]
    out = torch.empty((F.N_LIMBS, b), dtype=torch.int32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.c_void_p(x.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(buf.data_ptr()), arity, rf, rp, b,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _poseidon_cuda(field: FieldSpec, arity: int, x: torch.Tensor,
                   consts: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    lay = _layout(field, arity)
    buf = _buffer(field, arity, x.device, consts)
    out = _launch("poseidon", arity, lay.rf, lay.rp, x, buf)
    if x.shape[-1]:
        launches += 1
    return out


def _poseidon_dense_cuda(field: FieldSpec, arity: int, x: torch.Tensor,
                         consts: Optional[torch.Tensor]) -> torch.Tensor:
    global dense_launches
    lay = _dense_layout(field, arity)
    buf = _dense_buffer(field, arity, x.device, consts)
    out = _launch("poseidon_dense", arity, lay.rf, lay.rp, x, buf)
    if x.shape[-1]:
        dense_launches += 1
    return out


def _poseidon_folded_cuda(field: FieldSpec, arity: int, x: torch.Tensor,
                          consts: Optional[torch.Tensor]) -> torch.Tensor:
    global folded_launches
    lay = _folded_layout(field, arity)
    buf = _folded_buffer(field, arity, x.device, consts)
    out = _launch("poseidon_folded", arity, lay.rf, lay.rp, x, buf)
    if x.shape[-1]:
        folded_launches += 1
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


def poseidon_hash_dense(field: FieldSpec, arity: int, x: torch.Tensor,
                        consts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """As :func:`poseidon_hash`, through the dense schedule: CUDA tensors
    go through kernel K2, CPU tensors through
    :func:`poseidon_hash_dense_plain`; ``consts`` is a dense buffer
    (:func:`dense_constants_from_numpy`), by default the cached
    :func:`dense_constants`."""
    _check(arity, x)
    if x.device.type == "cuda":
        return _poseidon_dense_cuda(field, arity, x, consts)
    if x.device.type == "cpu":
        return poseidon_hash_dense_plain(field, arity, x, consts)
    raise ValueError(f"unsupported device {x.device}")


def poseidon_hash_folded(field: FieldSpec, arity: int, x: torch.Tensor,
                         consts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """As :func:`poseidon_hash`, through the folded schedule: CUDA
    tensors go through ``csrc/poseidon_folded.cu``, CPU tensors through
    :func:`poseidon_hash_folded_plain`; ``consts`` is a folded buffer
    (:func:`folded_constants_from_numpy`), by default the cached
    :func:`folded_constants`."""
    _check(arity, x)
    if x.device.type == "cuda":
        return _poseidon_folded_cuda(field, arity, x, consts)
    if x.device.type == "cpu":
        return poseidon_hash_folded_plain(field, arity, x, consts)
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
    return _hash_ints(poseidon_hash, field, arity, preimages_ints, device)


def hash_batch_dense(field: FieldSpec, arity: int, preimages_ints,
                     device=None) -> list:
    """As :func:`hash_batch`, through the dense schedule."""
    return _hash_ints(poseidon_hash_dense, field, arity, preimages_ints,
                      device)


def hash_batch_folded(field: FieldSpec, arity: int, preimages_ints,
                      device=None) -> list:
    """As :func:`hash_batch`, through the folded schedule."""
    return _hash_ints(poseidon_hash_folded, field, arity, preimages_ints,
                      device)


def _hash_ints(fn, field: FieldSpec, arity: int, preimages_ints,
               device) -> list:
    dev = resolve_device(device)
    if len(preimages_ints) == 0:
        return []
    x = preimages_to_tensor(field, arity, preimages_ints, dev)
    return F.limbs_to_ints(fn(field, arity, x).cpu().numpy().T)


def hash_batch_padded(field: FieldSpec, arity: int, preimages_ints,
                      device=None) -> list:
    """Same as :func:`hash_batch`. The JAX package pads batches to a few
    sizes to bound recompilation; the CUDA kernel takes any batch."""
    return hash_batch(field, arity, preimages_ints, device)
