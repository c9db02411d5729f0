"""Nova-style folding (NIFS) over relaxed R1CS with Pedersen commitments.

The port of the JAX package's ``proof/nova.py``: the NIFS primitives
(shapes, commitment keys, fold math) and the IVC loop
(``RecursiveSNARK`` / ``verify``, the reference's
``RecursiveSNARK::{new,prove_step,verify}`` driven by reference
src/proof/nova.rs:260-373). Relaxed R1CS: Az ∘ Bz = u·(Cz) + E with
z = (u | X | W).

Routes, one each and no fallback:

- the matvecs, the cross-term, the relaxed check and the witness folds
  go to the host C++ (:mod:`..hostlib.r1cs`, ``csrc/host/r1cs.cpp``);
  the JAX package's Python loops are the plain versions the tests hold
  them against;
- a commit of ``_DEVICE_COMMIT_THRESHOLD`` or more scalars on a CUDA key
  goes to the key's :class:`..msm.kernel.MsmTable` and the MSM kernel
  (K6) as packed words, with no Python ints; on a CPU key, to the host
  Pippenger (:mod:`..hostlib.msm`, ``csrc/host/msm.cpp``), as the JAX
  package commits without a device; while :func:`prover_devices` names
  several devices, to a :class:`ShardedMsmTable` over them;
- a smaller commit goes to the host Pippenger on either device (the
  Python ``Curve.pippenger``, the JAX package's route there, runs its
  whole bucket reduction at any size: ``scripts/torch_host_timings.py
  --lanes 32`` times both);
- points are added on the host (``fold_instance``).

Step vectors stay packed (:class:`..hostlib.r1cs.PackedVec`): each
step's W is packed once, and that one vector serves the W commit, the
z vector and the witness fold; the cross-term T comes back packed and
goes to its commit and fold the same way. Left out of the JAX
``CommitmentKey``: the TPU-era device/host race, its disk-cached route
and ``LURK_TPU_DEVICE_COMMITS``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..curves.weierstrass import Affine, CURVE_FOR_FIELD, Curve
from ..device import resolve_device
from ..hostlib import msm as host_msm
from ..hostlib import r1cs as hr
from ..hostlib.r1cs import PackedVec
from ..msm.kernel import MsmTable, to_affine
from ..parallel import sharding
from ..r1cs.cs import LC, ConstraintSystem
from ..utils import metrics, tracing
from .transcript import Transcript

# Commits of at least this many scalars go to the table or the host C++
# (nova.py:211, 249 of the JAX package use 64 for the native and mesh
# routes).
_DEVICE_COMMIT_THRESHOLD = 64


# ---------------------------------------------------------------------------
# Shape
# ---------------------------------------------------------------------------


class R1CSShape:
    """Frozen sparse R1CS over one field, z layout = (1|X | W)."""

    def __init__(self, cs: ConstraintSystem):
        self.p = cs.p
        self.field = cs.field
        self.num_inputs = cs.num_inputs          # includes the leading 1
        self.num_aux = cs.num_aux
        self.rows: List[Tuple[LC, LC, LC]] = cs.constraints
        # the digest of cs.shape_digest() and the CSR arrays in one pass
        self._csr, self.digest = hr.csr_and_digest(
            self.rows, cs.num_inputs, cs.num_aux, cs.p)

    @property
    def num_constraints(self) -> int:
        return len(self.rows)

    def csr(self) -> list:
        """The A, B and C matrices as ``(indptr, idx, coef limbs)``
        arrays (the host C++'s and the shape cache's layout), built with
        the digest or read from the shape cache."""
        return self._csr

    def matvecs(self, z) -> Tuple[List[int], List[int], List[int]]:
        return hr.matvecs(self, z)


# ---------------------------------------------------------------------------
# Pedersen commitment key
# ---------------------------------------------------------------------------


class CommitmentKey:
    """Generator basis for Pedersen vector commitments, committing on
    ``device`` (default ``cuda``)."""

    def __init__(self, curve: Curve, gens: List[Affine], device=None):
        self.curve = curve
        self.gens = gens
        self.device = resolve_device(device)
        self._table: Optional[MsmTable] = None
        self._sharded = None
        self._host_points: Optional[np.ndarray] = None
        self._small_points: Optional[np.ndarray] = None

    @staticmethod
    def setup(curve: Curve, label: bytes, n: int,
              device=None) -> "CommitmentKey":
        """BN254 G1 uses the HyperKZG powers-of-tau SRS as its basis (the
        reference's Bn256EngineKZG commits with the KZG engine,
        nova.rs:56-71); other curves use hash-derived generators. The
        prover's labels are ``b"lurk_tpu.ck." + curve.name`` and its
        sizes powers of two (``proof/supernova_cycle.py:138-147``)."""
        with tracing.span("params.srs", n=n):
            if curve.name == "bn254-g1":
                from .hyperkzg import load_srs
                gens = load_srs(n).powers
            else:
                from .params_cache import load_generators
                gens = load_generators(curve, label, n)
        return CommitmentKey(curve, gens, device)

    def table(self) -> MsmTable:
        """The key's MSM table on its device, built at first use."""
        if self._table is None:
            with metrics.timed("ck.table"):
                self._table = MsmTable.build(self.curve, self.gens,
                                             self.device)
        return self._table

    def sharded_table(self, devices) -> "sharding.ShardedMsmTable":
        """The key's table sharded over ``devices``, built at first use."""
        if self._sharded is None or self._sharded.devices != list(devices):
            self._sharded = sharding.ShardedMsmTable(devices, self.curve,
                                                     self.gens)
        return self._sharded

    def host_points(self) -> np.ndarray:
        """The generators packed for the host MSM, built at first use."""
        if self._host_points is None:
            self._host_points = host_msm.pack_points(self.gens)
        return self._host_points

    def small_points(self) -> np.ndarray:
        """The first ``_DEVICE_COMMIT_THRESHOLD`` generators packed for
        the host MSM (the route of short commits on every device)."""
        if self._small_points is None:
            self._small_points = host_msm.pack_points(
                self.gens[:_DEVICE_COMMIT_THRESHOLD])
        return self._small_points

    def _check(self, vec) -> int:
        n = len(vec)
        if n > len(self.gens):
            raise ValueError(f"commitment key too small: {n} scalars, "
                             f"{len(self.gens)} generators")
        return n

    def commit(self, vec) -> Affine:
        """Σ vec_i G_i for a sequence of ints or a :class:`PackedVec`
        over the curve's group order."""
        return self.commit_async(vec)()

    def commit_async(self, vec) -> Callable[[], Affine]:
        """Dispatch the commit without waiting for the card when it goes
        to the single table; returns a zero-argument resolver."""
        n = self._check(vec)
        if n < _DEVICE_COMMIT_THRESHOLD:
            pt = host_msm.msm(self.curve,
                              PackedVec.pack(vec, self.curve.order).arr,
                              self.small_points())
            return lambda: pt
        devices = sharding.prover_devices()
        if devices is not None:
            pt = self.sharded_table(devices).msm(list(vec))
            return lambda: pt
        packed = PackedVec.pack(vec, self.curve.order)
        if self.device.type == "cpu":
            pt = host_msm.msm(self.curve, packed.arr, self.host_points())
            return lambda: pt
        words = torch.from_numpy(packed.arr.view(np.int32).reshape(n, 8))
        out = self.table().msm_words_async(words)
        return lambda: to_affine(self.curve, out)


# ---------------------------------------------------------------------------
# Instances / witnesses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class R1CSInstance:
    """Strict instance: u = 1, E = 0."""

    comm_w: Affine
    x: List[int]


@dataclasses.dataclass
class RelaxedInstance:
    comm_w: Affine
    comm_e: Affine
    x: List[int]
    u: int

    @staticmethod
    def default(shape: R1CSShape) -> "RelaxedInstance":
        return RelaxedInstance(None, None, [0] * (shape.num_inputs - 1), 0)


@dataclasses.dataclass
class RelaxedWitness:
    w: PackedVec
    e: PackedVec

    @staticmethod
    def default(shape: R1CSShape) -> "RelaxedWitness":
        return RelaxedWitness(PackedVec.zeros(shape.num_aux, shape.p),
                              PackedVec.zeros(shape.num_constraints, shape.p))


def z_vector(shape: R1CSShape, x: Sequence[int], w, u: int = 1) -> PackedVec:
    """(u | X | W): the leading public ONE generalizes to u when
    relaxed."""
    return hr.pv_concat([u] + list(x), w, shape.p)


def check_strict(shape: R1CSShape, x: Sequence[int], w) -> bool:
    return hr.check_relaxed(shape, z_vector(shape, x, w, 1), 1,
                            PackedVec.zeros(shape.num_constraints, shape.p))


def check_relaxed(shape: R1CSShape, inst: RelaxedInstance,
                  wit: RelaxedWitness) -> bool:
    return hr.check_relaxed(shape, z_vector(shape, inst.x, wit.w, inst.u),
                            inst.u, wit.e)


# ---------------------------------------------------------------------------
# NIFS
# ---------------------------------------------------------------------------


def cross_term(shape: R1CSShape, inst1: RelaxedInstance,
               wit1: RelaxedWitness, x2: Sequence[int], w2) -> PackedVec:
    """T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − Cz1  (u2 = 1 strict)."""
    z1 = z_vector(shape, inst1.x, wit1.w, inst1.u)
    z2 = z_vector(shape, x2, w2, 1)
    return hr.cross_term_pv(shape, z1, inst1.u, z2)


def _absorb_relaxed(tr: Transcript, inst: RelaxedInstance) -> None:
    tr.absorb_point(inst.comm_w)
    tr.absorb_point(inst.comm_e)
    tr.absorb_scalar(inst.u)   # u accumulates in the scalar field: lossless
    for v in inst.x:
        tr.absorb_scalar(v)


def _absorb_strict(tr: Transcript, inst: R1CSInstance) -> None:
    tr.absorb_point(inst.comm_w)
    for v in inst.x:
        tr.absorb_scalar(v)


def fold_challenge(curve: Curve, shape_digest: str,
                   acc: RelaxedInstance, new: R1CSInstance,
                   comm_t: Affine) -> int:
    tr = Transcript(curve, b"nova.fold")
    tr.absorb(int(shape_digest[:32], 16))
    _absorb_relaxed(tr, acc)
    _absorb_strict(tr, new)
    tr.absorb_point(comm_t)
    return tr.squeeze()


def fold_instance(curve: Curve, acc: RelaxedInstance, new: R1CSInstance,
                  comm_t: Affine, r: int, order: int) -> RelaxedInstance:
    comm_w = curve.add(acc.comm_w, curve.mul(r, new.comm_w))
    comm_e = curve.add(acc.comm_e, curve.mul(r, comm_t))
    x = [(a + r * b) % order for a, b in zip(acc.x, new.x)]
    return RelaxedInstance(comm_w, comm_e, x, (acc.u + r) % order)


def fold_witness(p: int, acc: RelaxedWitness, w2, t,
                 r: int) -> RelaxedWitness:
    return RelaxedWitness(hr.vec_rlc_pv(p, acc.w, w2, r),
                          hr.vec_rlc_pv(p, acc.e, t, r))


# ---------------------------------------------------------------------------
# IVC: the step loop and its verifier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PublicParams:
    shape: R1CSShape
    curve: Curve
    ck: CommitmentKey

    @staticmethod
    def setup(shape: R1CSShape, curve: Optional[Curve] = None,
              device=None) -> "PublicParams":
        if curve is None:
            # the commitment curve's group order must equal the circuit
            # field, else Pedersen folding linearity breaks
            curve = CURVE_FOR_FIELD[shape.field.name]
        if curve.order != shape.p:
            raise ValueError(f"curve {curve.name} order != circuit field")
        # next power of two: the Spartan/IPA compression layer opens
        # commitments over pow2-padded vectors, and Pedersen prefix
        # consistency means the padded commitment equals the unpadded
        # one, so one key serves both paths.
        n = max(shape.num_aux, shape.num_constraints, shape.num_inputs, 2)
        n = 1 << (n - 1).bit_length()
        return PublicParams(shape, curve, CommitmentKey.setup(
            curve, b"lurk_tpu.ck." + curve.name.encode(), n, device))


@dataclasses.dataclass
class FoldingProof:
    """Fold chain: per-step strict instances + cross-term commitments,
    plus the final accumulated witness (uncompressed)."""

    steps: List[Tuple[R1CSInstance, Affine]]   # (instance_i, comm_T_i)
    final_witness: RelaxedWitness
    z0: List[int]
    zi: List[int]


class RecursiveSNARK:
    """Accumulates per-step (x, w) pairs (prove_step parity). Each step
    records its phases' host-clock seconds in :mod:`..utils.metrics`
    (``nova.pack``, ``nova.commit_w``, ``nova.cross_term``,
    ``nova.commit_t``, ``nova.fold``)."""

    def __init__(self, pp: PublicParams):
        self.pp = pp
        self.acc_inst = RelaxedInstance.default(pp.shape)
        self.acc_wit = RelaxedWitness.default(pp.shape)
        self.steps: List[Tuple[R1CSInstance, Affine]] = []
        self.z0: Optional[List[int]] = None
        self.zi: Optional[List[int]] = None

    def prove_step(self, x: List[int], w, check: bool = False) -> None:
        pp = self.pp
        shape = pp.shape
        with metrics.timed("nova.pack"):
            w = PackedVec.pack(w, shape.p)
        if check and not check_strict(shape, x, w):
            raise ValueError("step witness unsatisfied")
        with metrics.timed("nova.commit_w"):
            comm_w = pp.ck.commit(w)
        inst = R1CSInstance(comm_w, list(x))
        with metrics.timed("nova.cross_term"):
            t = cross_term(shape, self.acc_inst, self.acc_wit, x, w)
        with metrics.timed("nova.commit_t"):
            comm_t = pp.ck.commit(t)
        with metrics.timed("nova.fold"):
            r = fold_challenge(pp.curve, shape.digest, self.acc_inst, inst,
                               comm_t)
            self.acc_inst = fold_instance(pp.curve, self.acc_inst, inst,
                                          comm_t, r, shape.p)
            self.acc_wit = fold_witness(shape.p, self.acc_wit, w, t, r)
        self.steps.append((inst, comm_t))

    def finish(self) -> FoldingProof:
        if self.z0 is None or self.zi is None:
            raise ValueError("z0 and zi must be set before finish")
        return FoldingProof(self.steps, self.acc_wit, self.z0, self.zi)


def verify(pp: PublicParams, proof: FoldingProof,
           io_chain_check=None) -> bool:
    """Recompute the fold chain and check the final relaxed witness.

    `io_chain_check(x_list)` optionally validates the step-to-step IO
    linkage (e.g. MultiFrame z_out == next z_in)."""
    shape = pp.shape
    # A zero-step proof is vacuous: the all-zero default accumulator is
    # satisfied by the default zero witness. Reject it (and malformed
    # public IO or witness lengths) here so direct callers are protected,
    # not only those routed through io_chain_checker.
    if not proof.steps:
        return False
    if any(len(inst.x) != shape.num_inputs - 1 for inst, _ in proof.steps):
        return False
    wit = proof.final_witness
    if len(wit.w) != shape.num_aux or len(wit.e) != shape.num_constraints:
        return False
    acc = RelaxedInstance.default(shape)
    for inst, comm_t in proof.steps:
        r = fold_challenge(pp.curve, shape.digest, acc, inst, comm_t)
        acc = fold_instance(pp.curve, acc, inst, comm_t, r, shape.p)
    if io_chain_check is not None:
        if not io_chain_check([inst.x for inst, _ in proof.steps]):
            return False
    # final relaxed satisfaction
    if not check_relaxed(shape, acc, wit):
        return False
    # commitment consistency of the final accumulator
    if pp.ck.commit(wit.w) != acc.comm_w:
        return False
    if pp.ck.commit(wit.e) != acc.comm_e:
        return False
    return True
