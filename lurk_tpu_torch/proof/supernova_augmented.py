"""SuperNova augmented circuits: in-circuit NON-UNIFORM fold verification.

A copy of the JAX package's ``proof/supernova_augmented.py``.

Functionality parity target: arecibo's supernova circuits (external
crate, driven by reference src/proof/supernova.rs) — true NIVC:
the proof stays O(#circuits) regardless of step count.

Protocol (extends proof/augmented.py's cycle design):

  primary circuit for index `pc` over F1 (X = [h_in, h_out]):
      h = H1(pp, i, z0, zi, pc, U2, g_link)
      - binds pc_in == its own circuit index (base step only runs
        index 0);
      - folds the pending SECONDARY instance into U2 (E2 native);
      - runs its step function (z_next, pc_next) = F_pc(zi);
      - h_out = H1(pp, i+1, z0, z_next, pc_next, U2', u2.x[1]).

  secondary circuit over F2 (X = [g_in, g_out]):
      g = H2(pp, i, {U1_j}_j, h_link)
      - holds ONE running accumulator per primary circuit;
      - folds the pending PRIMARY instance (E1 native) into the
        accumulator SELECTED by the witnessed pc (the fold challenge
        absorbs pc; a mismatched pc is caught by the per-shape relaxed
        checks at final verification).

The secondary is uniform (one shape) because fold verification never
touches the folded instance's R1CS matrices — only its commitments and
public IO. Its cost grows O(#circuits) from the accumulator-list hash
and the select/scatter muxes, mirroring SuperNova's verifier-state
design.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

from ..curves.weierstrass import Affine, Curve
from ..r1cs.bignat import BigNat, alloc_bignat
from ..r1cs.cs import ConstraintSystem, lc_add, lc_sub
from ..r1cs.gadgets import (
    Bool, Num, alloc_bit, alloc_input_num, alloc_is_zero, alloc_num,
    enforce_equal,
)
from ..r1cs.ro_gadget import TranscriptGadget
from .augmented import (
    AllocRelaxed, _absorb_relaxed_gadget, alloc_point,
    alloc_relaxed, fold_relaxed_gadget, relaxed_select,
)
from .nova import RelaxedInstance


def sn_state1_gadget(cs: ConstraintSystem, p_other: int, pp: Num, i: Num,
                     z0: Sequence[Num], zi: Sequence[Num], pc: Num,
                     acc: AllocRelaxed, link: BigNat) -> Num:
    tr = TranscriptGadget(cs, b"snova.state1")
    tr.absorb(pp)
    tr.absorb(i)
    for v in z0:
        tr.absorb(v)
    for v in zi:
        tr.absorb(v)
    tr.absorb(pc)
    _absorb_relaxed_gadget(tr, acc, p_other)
    tr.absorb_bignat(link, p_other)
    return tr.squeeze()[0]


def sn_state2_gadget(cs: ConstraintSystem, p_other: int, pp: Num, i: Num,
                     accs: Sequence[AllocRelaxed], link: BigNat) -> Num:
    tr = TranscriptGadget(cs, b"snova.state2")
    tr.absorb(pp)
    tr.absorb(i)
    for acc in accs:
        _absorb_relaxed_gadget(tr, acc, p_other)
    tr.absorb_bignat(link, p_other)
    return tr.squeeze()[0]


@dataclasses.dataclass
class SnPrimaryCfg:
    curve_other: Curve
    p_other: int
    io_arity: int
    circuit_index: int
    # step_fn(cs, zi_nums, step_aux) -> (z_next_nums, pc_next_num)
    step_fn: Callable[[ConstraintSystem, List[Num], Any],
                      Tuple[List[Num], Num]]
    # whether a chain may START at this circuit (Lurk: only pc 0;
    # memoset: any index)
    base_allowed: bool = False


@dataclasses.dataclass
class SnPrimaryWitness:
    h_in: int
    h_out: int
    pp: int
    i: int
    z0: List[int]
    zi: List[int]
    pc_in: int
    acc: RelaxedInstance          # U2 before this step's fold
    new_w: Affine                 # pending secondary instance
    new_x: List[int]
    comm_t: Affine
    step_aux: Any = None
    # precomputed step-function witness (aux segment, z_next values,
    # pc_next value): accumulator-independent, so generated ahead of the
    # fold loop in parallel workers (witness-gen ∥ folding — reference
    # src/proof/supernova.rs:248-285). Replayed under witness_only.
    step_cache: Any = None


def synthesize_sn_primary(cs: ConstraintSystem, cfg: SnPrimaryCfg,
                          w: SnPrimaryWitness) -> Tuple[List[Num], Num]:
    """Returns (z_next, pc_next). Public X = [h_in, h_out]."""
    p = cs.p
    curve = cfg.curve_other
    p2 = cfg.p_other
    h_in = alloc_input_num(cs, w.h_in)
    h_out = alloc_input_num(cs, w.h_out)

    pp = alloc_num(cs, w.pp)
    i = alloc_num(cs, w.i)
    z0 = [alloc_num(cs, v) for v in w.z0]
    zi = [alloc_num(cs, v) for v in w.zi]
    pc_in = alloc_num(cs, w.pc_in)
    acc = alloc_relaxed(cs, curve, p2, w.acc)
    new_w = alloc_point(cs, curve, w.new_w)
    new_x = [alloc_bignat(cs, v, p2) for v in w.new_x]
    comm_t = alloc_point(cs, curve, w.comm_t)

    base = alloc_is_zero(cs, i)
    not_base = base.not_()

    # pc binding: this circuit IS index circuit_index
    enforce_equal(cs, pc_in, Num.constant(cs, cfg.circuit_index))
    if not cfg.base_allowed and cfg.circuit_index != 0:
        cs.enforce(base.lc(cs), {ConstraintSystem.ONE_VAR: 1}, {})

    # input-hash integrity
    h_calc = sn_state1_gadget(cs, p2, pp, i, z0, zi, pc_in, acc,
                              new_x[0])
    cs.enforce(not_base.lc(cs), lc_sub(h_in.lc, h_calc.lc, p), {})
    cs.enforce(base.lc(cs), h_in.lc, {})

    # base-case pinning: zi == z0; U2 default; links zero
    for a, b in zip(zi, z0):
        cs.enforce(base.lc(cs), lc_sub(a.lc, b.lc, p), {})
    for pf in (acc.comm_w, acc.comm_e):
        cs.enforce(base.lc(cs), pf.is_id.not_().lc(cs), {})
    for bn in [acc.u] + acc.x + [new_x[0], new_x[1]]:
        for limb in bn.limbs:
            cs.enforce(base.lc(cs), limb.lc, {})

    # fold the pending secondary into U2 (skipped at base)
    folded = fold_relaxed_gadget(cs, curve, p2, pp, acc, new_w, new_x,
                                 comm_t)
    acc_next = relaxed_select(cs, base, acc, folded)

    # the step function
    if w.step_cache is not None and cs.witness_only:
        seg, out_values, pc_next_value = w.step_cache
        cs.aux.extend(seg)
        z_next = [Num({}, v) for v in out_values]
        pc_next = Num({}, pc_next_value)
    else:
        z_next, pc_next = cfg.step_fn(cs, zi, w.step_aux)
    assert len(z_next) == cfg.io_arity

    one = {ConstraintSystem.ONE_VAR: 1}
    i_next = Num(lc_add(i.lc, one, p), (i.value + 1) % p)
    h_out_calc = sn_state1_gadget(cs, p2, pp, i_next, z0, z_next,
                                  pc_next, acc_next, new_x[1])
    enforce_equal(cs, h_out, h_out_calc)
    return z_next, pc_next


@dataclasses.dataclass
class SnSecondaryCfg:
    curve_other: Curve            # the primary curve (E1)
    p_other: int                  # F1 modulus
    n_circuits: int


@dataclasses.dataclass
class SnSecondaryWitness:
    g_in: int
    g_out: int
    pp: int
    i: int
    pc: int                       # index of the folded primary instance
    accs: List[RelaxedInstance]   # U1 list before this step's fold
    new_w: Affine                 # pending primary instance
    new_x: List[int]
    comm_t: Affine


def synthesize_sn_secondary(cs: ConstraintSystem, cfg: SnSecondaryCfg,
                            w: SnSecondaryWitness) -> None:
    """Public X = [g_in, g_out]."""
    p = cs.p
    curve = cfg.curve_other
    p2 = cfg.p_other
    n = cfg.n_circuits
    g_in = alloc_input_num(cs, w.g_in)
    g_out = alloc_input_num(cs, w.g_out)

    pp = alloc_num(cs, w.pp)
    i = alloc_num(cs, w.i)
    pc = alloc_num(cs, w.pc)
    accs = [alloc_relaxed(cs, curve, p2, a) for a in w.accs]
    new_w = alloc_point(cs, curve, w.new_w)
    new_x = [alloc_bignat(cs, v, p2) for v in w.new_x]
    comm_t = alloc_point(cs, curve, w.comm_t)

    base = alloc_is_zero(cs, i)
    not_base = base.not_()

    g_calc = sn_state2_gadget(cs, p2, pp, i, accs, new_x[0])
    cs.enforce(not_base.lc(cs), lc_sub(g_in.lc, g_calc.lc, p), {})
    cs.enforce(base.lc(cs), g_in.lc, {})

    # base pinning: every accumulator default; h link zero
    for acc in accs:
        for pf in (acc.comm_w, acc.comm_e):
            cs.enforce(base.lc(cs), pf.is_id.not_().lc(cs), {})
        for bn in [acc.u] + acc.x:
            for limb in bn.limbs:
                cs.enforce(base.lc(cs), limb.lc, {})
    for limb in new_x[0].limbs:
        cs.enforce(base.lc(cs), limb.lc, {})

    # pc one-hot selector
    sels: List[Bool] = []
    sel_sum = {}
    idx_sum = {}
    for j in range(n):
        b = alloc_bit(cs, w.pc == j)
        sels.append(b)
        sel_sum = lc_add(sel_sum, b.lc(cs), p)
        idx_sum = lc_add(idx_sum, {k: (v * j) % p
                                   for k, v in b.lc(cs).items()}, p)
    cs.enforce({ConstraintSystem.ONE_VAR: 1}, sel_sum,
               {ConstraintSystem.ONE_VAR: 1})
    cs.enforce({ConstraintSystem.ONE_VAR: 1}, idx_sum, pc.lc)

    # gather the selected accumulator, fold, scatter back
    acc_sel = accs[0]
    for j in range(1, n):
        acc_sel = relaxed_select(cs, sels[j], accs[j], acc_sel)
    folded = fold_relaxed_gadget(cs, curve, p2, pp, acc_sel, new_w,
                                 new_x, comm_t, extra=(pc,))
    accs_next = [relaxed_select(cs, sels[j], folded, accs[j])
                 for j in range(n)]

    one = {ConstraintSystem.ONE_VAR: 1}
    i_next = Num(lc_add(i.lc, one, p), (i.value + 1) % p)
    g_out_calc = sn_state2_gadget(cs, p2, pp, i_next, accs_next,
                                  new_x[1])
    enforce_equal(cs, g_out, g_out_calc)
