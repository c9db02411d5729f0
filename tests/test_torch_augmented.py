"""The port's augmented-circuit gadgets (``lurk_tpu_torch.r1cs.{bignat,
ec_gadgets,ro_gadget}``, ``proof.{augmented,supernova_augmented}``)
against integers, the host curve and transcript, and the JAX package:
cut down from tests/test_aug_gadgets.py and tests/test_ec_gadgets.py.
Every circuit is built with its constraints checked as they are
recorded. Integers only: tolerance 0."""

import random

import pytest

from lurk_tpu.curves.weierstrass import CURVE_FOR_FIELD as JAX_CURVES
from lurk_tpu.fields import FIELDS as JAX_FIELDS
from lurk_tpu.proof import augmented as jax_aug
from lurk_tpu.proof import nova as jax_nova
from lurk_tpu.proof import supernova_augmented as jax_sn
from lurk_tpu.r1cs import bignat as jax_bignat
from lurk_tpu.r1cs import gadgets as jax_gadgets
from lurk_tpu.r1cs.cs import ConstraintSystem as JaxCS
from lurk_tpu_torch.curves.weierstrass import (
    CURVE_FOR_FIELD, GRUMPKIN, PALLAS, VESTA,
)
from lurk_tpu_torch.fields import FIELDS, PALLAS_SCALAR, VESTA_SCALAR
from lurk_tpu_torch.proof import augmented as aug
from lurk_tpu_torch.proof import nova
from lurk_tpu_torch.proof import supernova_augmented as sn
from lurk_tpu_torch.proof.transcript import CHALLENGE_BITS, Transcript
from lurk_tpu_torch.r1cs import bignat, gadgets
from lurk_tpu_torch.r1cs.cs import ConstraintSystem
from lurk_tpu_torch.r1cs.ec_gadgets import (
    AllocatedPoint, ec_add, ec_normalize, ec_scalar_mul, enforce_on_curve,
)
from lurk_tpu_torch.r1cs.gadgets import Bool, Num, alloc_bit, alloc_num
from lurk_tpu_torch.r1cs.ro_gadget import TranscriptGadget
from test_torch_field import one_torch_thread  # noqa: F401

F1 = PALLAS_SCALAR          # circuit field
P2 = VESTA_SCALAR.modulus   # nonnative modulus


def bignat_ops(bn, gad, cs, cases):
    """The fold's bignat operations on ``cases`` of (a, b, r); returns
    the results' values."""
    out = []
    for a_v, b_v, r_v in cases:
        a = bn.alloc_bignat(cs, a_v, P2)
        b = bn.alloc_bignat(cs, b_v, P2)
        r = gad.alloc_num(cs, r_v)
        out.append(bn.bignat_add_challenge(cs, a, r, r_v, P2).value)
        out.append(bn.bignat_mul_add_challenge(cs, a, b, r, r_v, P2).value)
        sel = bn.bignat_select(cs, gad.alloc_bit(cs, True), a, b)
        bn.bignat_enforce_equal(cs, sel, a)
        out.append(sel.lo_hi()[1].value)
    return out


def test_bignat_fold_ops_match_ints_and_jax():
    rng = random.Random(11)
    cases = [(rng.randrange(P2), rng.randrange(P2),
              rng.randrange(1 << CHALLENGE_BITS)) for _ in range(3)]
    cases += [(P2 - 1, P2 - 1, 1), (0, P2 - 1, 0)]   # wrap, zero
    cs = ConstraintSystem(F1, check=True)
    got = bignat_ops(bignat, gadgets, cs, cases)
    want = []
    for a, b, r in cases:
        want += [(a + r) % P2, (a + r * b) % P2, a >> 128]
    assert got == want
    assert cs.is_satisfied()
    jcs = JaxCS(JAX_FIELDS[F1.name], check=True)
    assert bignat_ops(jax_bignat, jax_gadgets, jcs, cases) == want
    assert (cs.num_constraints, cs.num_aux, cs.shape_digest()) == \
        (jcs.num_constraints, jcs.num_aux, jcs.shape_digest())


@pytest.mark.parametrize("circuit,curve", [(VESTA_SCALAR, PALLAS),
                                           (PALLAS_SCALAR, VESTA)],
                         ids=["split", "whole"])
def test_transcript_gadget_matches_host(circuit, curve):
    """Same absorbs -> same challenge, twice; a scalar of the curve's
    order is split in two limbs when the order exceeds the circuit field
    (Pallas' over the Vesta field) and absorbed whole otherwise."""
    rng = random.Random(5)
    cs = ConstraintSystem(circuit, check=True)
    tr = Transcript(curve, b"test.ro")
    g = TranscriptGadget(cs, b"test.ro")
    for v in [rng.randrange(circuit.modulus) for _ in range(3)]:
        tr.absorb(v)
        g.absorb(alloc_num(cs, v))
    q = curve.order
    s = q - 1 - rng.randrange(1 << 100)
    tr.absorb_scalar(s)
    g.absorb_bignat(bignat.alloc_bignat(cs, s, q), q)
    pt = curve.mul(rng.randrange(1, q), curve.generator)
    tr.absorb_point(pt)
    tr.absorb_point(None)
    g.absorb_point(alloc_num(cs, pt[0]), alloc_num(cs, pt[1]), Bool.false())
    g.absorb_point(Num.constant(cs, 0), Num.constant(cs, 0), Bool.true())
    want = tr.squeeze()
    got, bits = g.squeeze()
    assert got.value == want
    assert sum(int(b.value) << i for i, b in enumerate(bits)) == want
    assert len(bits) == CHALLENGE_BITS
    tr.absorb(42)
    g.absorb_const(42)
    assert g.squeeze()[0].value == tr.squeeze()
    assert cs.is_satisfied()


@pytest.mark.parametrize("curve", [VESTA, GRUMPKIN], ids=lambda c: c.name)
def test_ec_gadgets_match_host_curve(curve):
    rng = random.Random(7)
    cs = ConstraintSystem(curve.base, check=True)
    a = curve.mul(rng.randrange(1, curve.order), curve.generator)
    b = curve.mul(rng.randrange(1, curve.order), curve.generator)
    pa = AllocatedPoint.alloc_affine(cs, a)
    pb = AllocatedPoint.alloc_affine(cs, b)
    enforce_on_curve(cs, curve, pa)
    enforce_on_curve(cs, curve, pb)
    assert ec_add(cs, curve, pa, pb).value(curve) == curve.add(a, b)
    assert ec_add(cs, curve, pa, pa).value(curve) == curve.double(a)
    ident = AllocatedPoint.identity(cs)
    assert ec_add(cs, curve, pa, ident).value(curve) == a
    neg = AllocatedPoint.alloc_affine(cs, curve.neg(a))
    assert ec_add(cs, curve, pa, neg).value(curve) is None
    k = 0b10110101
    bits = [alloc_bit(cs, bool((k >> i) & 1)) for i in range(8)]
    assert ec_scalar_mul(cs, curve, bits, pa).value(curve) == curve.mul(k, a)
    x, y, is_id = ec_normalize(cs, curve, ec_add(cs, curve, pa, pb))
    assert (x.value, y.value) == curve.add(a, b) and not is_id.value
    xi, yi, idf = ec_normalize(cs, curve, ident)
    assert (xi.value, yi.value) == (0, 0) and idf.value
    assert cs.is_satisfied()


def blank_secondary(curves, fields, nova_mod, aug_mod, sn_mod, cs_cls,
                    kind: str, n: int):
    """The blank secondary circuit of the bn256 cycle, as its shape is
    synthesized: the SuperNova one over ``n`` primary circuits, or the
    Nova one (``augmented`` with no step function)."""
    curve1 = curves["bn256"]
    p1 = fields["bn256"].modulus
    cs = cs_cls(curve1.base)

    def default():
        return nova_mod.RelaxedInstance(None, None, [0, 0], 0)

    if kind == "supernova":
        cfg = sn_mod.SnSecondaryCfg(curve_other=curve1, p_other=p1,
                                    n_circuits=n)
        w = sn_mod.SnSecondaryWitness(0, 0, 0, 0, 0,
                                      [default() for _ in range(n)],
                                      None, [0, 0], None)
        sn_mod.synthesize_sn_secondary(cs, cfg, w)
    else:
        cfg = aug_mod.AugmentedCfg(curve_other=curve1, p_other=p1,
                                   io_arity=0, fold_at_base=True)
        w = aug_mod.AugmentedWitness(0, 0, 0, 0, [], [], default(), None,
                                     [0, 0], None)
        aug_mod.synthesize_augmented(cs, cfg, w)
    return cs


@pytest.mark.parametrize("kind,n", [("supernova", 1), ("supernova", 2),
                                    ("nova", 1)])
def test_secondary_circuit_matches_jax(kind, n):
    cs = blank_secondary(CURVE_FOR_FIELD, FIELDS, nova, aug, sn,
                         ConstraintSystem, kind, n)
    jcs = blank_secondary(JAX_CURVES, JAX_FIELDS, jax_nova, jax_aug,
                          jax_sn, JaxCS, kind, n)
    assert cs.num_constraints > 10_000
    assert (cs.num_constraints, cs.num_aux, cs.num_inputs) == \
        (jcs.num_constraints, jcs.num_aux, jcs.num_inputs)
    assert cs.shape_digest() == jcs.shape_digest()
    assert nova.R1CSShape(cs).digest == jax_nova.R1CSShape(jcs).digest
