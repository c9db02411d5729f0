"""The Nova augmented circuit: in-circuit fold verification on a cycle.

A copy of the JAX package's ``proof/augmented.py``.

Functionality parity target: arecibo's `NovaAugmentedCircuit` (external
crate, driven by reference src/proof/nova.rs:92-162) — the circuit
that makes Nova TRUE IVC: each step circuit additionally verifies one
fold of the OTHER curve's running instance, so the final proof is O(1)
(two relaxed accumulators + one pending strict instance) instead of the
whole fold chain.

Protocol (ours; arecibo publishes no offline vectors, so this is a
self-consistent redesign with the same guarantees — see
the JAX package's proof/nova_cycle.py for the soundness sketch):

  primary circuit over F1  (public X = [h_in, h_out]):
      h = H1(pp, i, z0, zi, U2, g_link)   — the chain state hash
      folds the pending SECONDARY instance u2 into U2 (E2 points are
      native here), runs the step function z_{i+1} = F(zi), and binds
      h_out = H1(pp, i+1, z0, z_{i+1}, U2', u2.x[1]).
  secondary circuit over F2 (public X = [g_in, g_out]):
      g = H2(pp, j, U1, h_link) — no step function; folds the PRIMARY
      instance u1 (E1 points native here) into U1.

All hashes and fold challenges run through the SAME transcript protocol
as the host (proof/transcript.py / r1cs/ro_gadget.py — bit-exact), so
host folds and in-circuit folds agree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

from ..curves.weierstrass import Affine, Curve
from ..r1cs.bignat import (
    BigNat, alloc_bignat, bignat_add_challenge, bignat_mul_add_challenge,
    bignat_select,
)
from ..r1cs.cs import ConstraintSystem, lc_add, lc_sub
from ..r1cs.ec_gadgets import (
    AllocatedPoint, ec_add, ec_normalize, ec_scalar_mul, enforce_on_curve,
)
from ..r1cs.gadgets import (
    Bool, Num, alloc_input_num, alloc_is_zero, alloc_num, enforce_equal,
    pick,
)
from ..r1cs.ro_gadget import TranscriptGadget
from .nova import RelaxedInstance


# ---------------------------------------------------------------------------
# Allocated points carried in (affine, is_identity) hash form
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PointFlag:
    """(x, y, is_id): the transcript absorb form. Identity is pinned to
    coordinates (0, 0) so the triple uniquely determines the point."""

    x: Num
    y: Num
    is_id: Bool

    def value(self) -> Affine:
        return None if self.is_id.value else (self.x.value, self.y.value)


def alloc_point(cs: ConstraintSystem, curve: Curve, pt: Affine,
                check_on_curve: bool = True) -> PointFlag:
    is_id_bit = pt is None
    x = alloc_num(cs, 0 if is_id_bit else pt[0])
    y = alloc_num(cs, 0 if is_id_bit else pt[1])
    from ..r1cs.gadgets import alloc_bit
    flag = alloc_bit(cs, is_id_bit)
    # identity -> (0, 0)
    cs.enforce(flag.lc(cs), x.lc, {})
    cs.enforce(flag.lc(cs), y.lc, {})
    pf = PointFlag(x, y, flag)
    if check_on_curve:
        enforce_on_curve(cs, curve, to_projective(cs, pf))
    return pf


def to_projective(cs: ConstraintSystem, pf: PointFlag) -> AllocatedPoint:
    """Free (linear) lift: identity (0,0,flag=1) -> (0,1,0); else
    (x, y, 1). Relies on the (0,0)-at-identity pinning."""
    p = cs.p
    one = {ConstraintSystem.ONE_VAR: 1}
    y = Num(lc_add(pf.y.lc, pf.is_id.lc(cs), p),
            (pf.y.value + (1 if pf.is_id.value else 0)) % p)
    z = Num(lc_sub(one, pf.is_id.lc(cs), p),
            0 if pf.is_id.value else 1)
    return AllocatedPoint(pf.x, y, z)


def normalize_flag(cs: ConstraintSystem, curve: Curve,
                   pt: AllocatedPoint) -> PointFlag:
    x, y, is_id = ec_normalize(cs, curve, pt)
    return PointFlag(x, y, is_id)


def point_select(cs: ConstraintSystem, cond: Bool, a: PointFlag,
                 b: PointFlag) -> PointFlag:
    fa = Num(a.is_id.lc(cs), 1 if a.is_id.value else 0)
    fb = Num(b.is_id.lc(cs), 1 if b.is_id.value else 0)
    f = pick(cs, cond, fa, fb)
    return PointFlag(pick(cs, cond, a.x, b.x), pick(cs, cond, a.y, b.y),
                     Bool(f))


# ---------------------------------------------------------------------------
# Allocated relaxed instance of the OTHER circuit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AllocRelaxed:
    comm_w: PointFlag
    comm_e: PointFlag
    u: BigNat
    x: List[BigNat]


def alloc_relaxed(cs: ConstraintSystem, curve: Curve, p_other: int,
                  inst: RelaxedInstance) -> AllocRelaxed:
    return AllocRelaxed(
        alloc_point(cs, curve, inst.comm_w),
        alloc_point(cs, curve, inst.comm_e),
        alloc_bignat(cs, inst.u, p_other),
        [alloc_bignat(cs, v, p_other) for v in inst.x],
    )


def relaxed_select(cs: ConstraintSystem, cond: Bool, a: AllocRelaxed,
                   b: AllocRelaxed) -> AllocRelaxed:
    return AllocRelaxed(
        point_select(cs, cond, a.comm_w, b.comm_w),
        point_select(cs, cond, a.comm_e, b.comm_e),
        bignat_select(cs, cond, a.u, b.u),
        [bignat_select(cs, cond, xa, xb) for xa, xb in zip(a.x, b.x)],
    )


def _absorb_relaxed_gadget(tr: TranscriptGadget, acc: AllocRelaxed,
                           p_other: int) -> None:
    tr.absorb_point(acc.comm_w.x, acc.comm_w.y, acc.comm_w.is_id)
    tr.absorb_point(acc.comm_e.x, acc.comm_e.y, acc.comm_e.is_id)
    tr.absorb_bignat(acc.u, p_other)
    for v in acc.x:
        tr.absorb_bignat(v, p_other)


# ---------------------------------------------------------------------------
# Fold verification gadget (mirrors nova.fold_instance + the cycle
# transcript in the JAX package's nova_cycle.cycle_fold_challenge)
# ---------------------------------------------------------------------------


def fold_relaxed_gadget(cs: ConstraintSystem, curve: Curve, p_other: int,
                        pp: Num, acc: AllocRelaxed, new_w: PointFlag,
                        new_x: Sequence[BigNat],
                        comm_t: PointFlag,
                        extra: Sequence[Num] = ()) -> AllocRelaxed:
    tr = TranscriptGadget(cs, b"nova.fold")
    tr.absorb(pp)
    for v in extra:
        tr.absorb(v)
    _absorb_relaxed_gadget(tr, acc, p_other)
    tr.absorb_point(new_w.x, new_w.y, new_w.is_id)
    for v in new_x:
        tr.absorb_bignat(v, p_other)
    tr.absorb_point(comm_t.x, comm_t.y, comm_t.is_id)
    r, r_bits = tr.squeeze()
    r_int = r.value

    w_next = ec_add(cs, curve, to_projective(cs, acc.comm_w),
                    ec_scalar_mul(cs, curve, r_bits,
                                  to_projective(cs, new_w)))
    e_next = ec_add(cs, curve, to_projective(cs, acc.comm_e),
                    ec_scalar_mul(cs, curve, r_bits,
                                  to_projective(cs, comm_t)))
    u_next = bignat_add_challenge(cs, acc.u, r, r_int, p_other)
    x_next = [bignat_mul_add_challenge(cs, xa, xn, r, r_int, p_other)
              for xa, xn in zip(acc.x, new_x)]
    return AllocRelaxed(normalize_flag(cs, curve, w_next),
                        normalize_flag(cs, curve, e_next),
                        u_next, x_next)


# ---------------------------------------------------------------------------
# Chain state hash gadget (mirrors the JAX nova_cycle.cycle_state_hash)
# ---------------------------------------------------------------------------


def state_hash_gadget(cs: ConstraintSystem, p_other: int, pp: Num,
                      i: Num, z0: Sequence[Num], zi: Sequence[Num],
                      acc: AllocRelaxed, link: BigNat) -> Num:
    tr = TranscriptGadget(cs, b"nova.state")
    tr.absorb(pp)
    tr.absorb(i)
    for v in z0:
        tr.absorb(v)
    for v in zi:
        tr.absorb(v)
    _absorb_relaxed_gadget(tr, acc, p_other)
    tr.absorb_bignat(link, p_other)
    return tr.squeeze()[0]


# ---------------------------------------------------------------------------
# The augmented circuit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AugmentedCfg:
    """Static configuration of one side of the cycle."""

    curve_other: Curve            # curve committing the folded instances
    p_other: int                  # their scalar field (= circuit field of
                                  # the other side)
    io_arity: int                 # len(z); 0 on the secondary side
    fold_at_base: bool            # secondary folds even at step 0
    # step_fn(cs, zi_nums, step_aux) -> z_next_nums
    step_fn: Optional[Callable[[ConstraintSystem, List[Num], Any],
                               List[Num]]] = None


@dataclasses.dataclass
class AugmentedWitness:
    """Host values for one augmented-circuit synthesis."""

    h_in: int
    h_out: int
    pp: int
    i: int
    z0: List[int]
    zi: List[int]
    acc: RelaxedInstance          # accumulator BEFORE this step's fold
    new_w: Affine                 # pending strict instance: commitment
    new_x: List[int]              # ... and its public IO (2 elements)
    comm_t: Affine                # cross-term commitment of the fold
    step_aux: Any = None
    # precomputed step-function witness (aux segment + z_next values):
    # the step circuit's witness depends only on (zi, step_aux) — not on
    # the running accumulators — so it can be generated ahead of the
    # fold loop in parallel workers (the reference's witness-gen ∥
    # folding pipeline, src/proof/nova.rs:297-332). witness_only replays
    # it with one list extend.
    step_cache: Any = None


def synthesize_augmented(cs: ConstraintSystem, cfg: AugmentedCfg,
                         w: AugmentedWitness) -> List[Num]:
    """Build the augmented circuit; returns z_next (allocated). Public
    IO (allocated first): X = [h_in, h_out]."""
    p = cs.p
    curve = cfg.curve_other
    p2 = cfg.p_other
    h_in = alloc_input_num(cs, w.h_in)
    h_out = alloc_input_num(cs, w.h_out)

    pp = alloc_num(cs, w.pp)
    i = alloc_num(cs, w.i)
    z0 = [alloc_num(cs, v) for v in w.z0]
    zi = [alloc_num(cs, v) for v in w.zi]
    acc = alloc_relaxed(cs, curve, p2, w.acc)
    new_w = alloc_point(cs, curve, w.new_w)
    new_x = [alloc_bignat(cs, v, p2) for v in w.new_x]
    comm_t = alloc_point(cs, curve, w.comm_t)

    base = alloc_is_zero(cs, i)
    not_base = base.not_()

    # 1. input-hash integrity: (1-base) * (h_in - h_calc) = 0 and
    #    base * h_in = 0
    h_calc = state_hash_gadget(cs, p2, pp, i, z0, zi, acc, new_x[0])
    cs.enforce(not_base.lc(cs), lc_sub(h_in.lc, h_calc.lc, p), {})
    cs.enforce(base.lc(cs), h_in.lc, {})

    # 2. base-case pinning: zi == z0; acc == default (identity comms,
    #    u = 0, x = 0); link-in == 0; (primary only) link-out == 0
    for a, b in zip(zi, z0):
        cs.enforce(base.lc(cs), lc_sub(a.lc, b.lc, p), {})
    for pf in (acc.comm_w, acc.comm_e):
        cs.enforce(base.lc(cs), pf.is_id.not_().lc(cs), {})
    for bn in [acc.u] + acc.x + [new_x[0]] + \
            ([] if cfg.fold_at_base else [new_x[1]]):
        for limb in bn.limbs:
            cs.enforce(base.lc(cs), limb.lc, {})

    # 3. the fold (verified in-circuit; skipped via select at the
    #    primary's base step, where there is no pending instance yet)
    folded = fold_relaxed_gadget(cs, curve, p2, pp, acc, new_w, new_x,
                                 comm_t)
    if cfg.fold_at_base:
        acc_next = folded
    else:
        acc_next = relaxed_select(cs, base, acc, folded)

    # 4. the step function
    if cfg.io_arity:
        if w.step_cache is not None and cs.witness_only:
            seg, out_values = w.step_cache
            cs.aux.extend(seg)
            z_next = [Num({}, v) for v in out_values]
        else:
            z_next = cfg.step_fn(cs, zi, w.step_aux)
        assert len(z_next) == cfg.io_arity
    else:
        z_next = []

    # 5. output hash: h_out == H(pp, i+1, z0, z_next, acc_next, link-out)
    one = {ConstraintSystem.ONE_VAR: 1}
    i_next = Num(lc_add(i.lc, one, p), (i.value + 1) % p)
    h_out_calc = state_hash_gadget(cs, p2, pp, i_next, z0, z_next,
                                   acc_next, new_x[1])
    enforce_equal(cs, h_out, h_out_calc)
    return z_next
