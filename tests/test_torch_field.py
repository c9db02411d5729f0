"""The port's plain 256-bit Montgomery core (lurk_tpu_torch.ops.field)
against Python integers, for the four Lurk fields. Exact: tolerance 0."""

import numpy as np
import pytest
import torch

from lurk_tpu_torch.fields import FIELDS
from lurk_tpu_torch.ops import field as F

R = 1 << 256

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a port test module: the plain
    versions run many small ops, where a pool as wide as the machine,
    shared by several test workers, costs more than it gives. Every
    test_torch_*.py file imports this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def operands(p: int, seed: int):
    """Random residues plus the edge values 0, 1 and p-1."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(6)]
    a = rand[:3] + [0, 1, p - 1, p - 1, 0, 1]
    b = rand[3:] + [p - 1, p - 1, p - 1, 1, 0, 0]
    return a, b


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mul(name):
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    a, b = operands(p, 1)
    got = F.to_ints(F.mul(mf, F.from_ints(a), F.from_ints(b)))
    r_inv = pow(R, -1, p)
    assert got == [x * y * r_inv % p for x, y in zip(a, b)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_add(name):
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    a, b = operands(p, 2)
    got = F.to_ints(F.add(mf, F.from_ints(a), F.from_ints(b)))
    assert got == [(x + y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sub(name):
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    a, b = operands(p, 3)
    got = F.to_ints(F.sub(mf, F.from_ints(a), F.from_ints(b)))
    assert got == [(x - y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_montgomery_round_trip(name):
    """to_mont reduces any 256-bit input; from_mont inverts it."""
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    a, _ = operands(p, 4)
    wide = a + [p, 2 * p, 1 << 255, (1 << 255) + 12345, R - 1]
    mont = F.to_mont(mf, F.from_ints(wide))
    assert F.to_ints(mont) == [(v * R) % p for v in wide]
    assert F.to_ints(F.from_mont(mf, mont)) == [v % p for v in wide]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_addend_joins_the_reduction(name):
    """mul and dot with ``plus``: a sum of two canonical values (limbs up
    to 2^17) added before the one reduction."""
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    a, b = operands(p, 6)
    c, d = operands(p, 7)
    plus = F.from_ints(c) + F.from_ints(d)
    r_inv = pow(R, -1, p)
    got = F.to_ints(F.mul(mf, F.from_ints(a), F.from_ints(b), plus=plus,
                          plus_bound=2))
    assert got == [(x * y * r_inv + u + v) % p
                   for x, y, u, v in zip(a, b, c, d)]
    ta = F.from_ints(a + b).reshape(16, 2, len(a)).permute(1, 0, 2)
    tb = F.from_ints(b + a).reshape(16, 2, len(a)).permute(1, 0, 2)
    got = F.to_ints(F.dot(mf, ta, tb, dim=0, plus=plus, plus_bound=2))
    assert got == [(2 * x * y * r_inv + u + v) % p
                   for x, y, u, v in zip(a, b, c, d)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_canonical_and_dot(name):
    """Canonical reduction of 2^255-range values, and the single-REDC
    dot product over a leading axis."""
    mf = F.mont_field(FIELDS[name])
    p = mf.modulus
    wide = [R - 1, 1 << 255, 5 * p % R, p, p - 1, 0]
    assert F.to_ints(F.canonical(mf, F.from_ints(wide))) == \
        [v % p for v in wide]
    rng = np.random.default_rng(5)
    k = 9
    a = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(3)]
         for _ in range(k)]
    b = [[p - 1 - (i * 7919 + j) for j in range(3)] for i in range(k)]
    ta = F.from_ints(sum(a, [])).reshape(16, k, 3).permute(1, 0, 2)
    tb = F.from_ints(sum(b, [])).reshape(16, k, 3).permute(1, 0, 2)
    got = F.to_ints(F.dot(mf, ta, tb, dim=0))
    r_inv = pow(R, -1, p)
    assert got == [sum(a[i][j] * b[i][j] for i in range(k)) * r_inv % p
                   for j in range(3)]
