"""The port's ZData format and legacy Z store (``lurk_tpu_torch.store.
{z_data,z_legacy}``) against the JAX package's on the CPU. Bytes and
digests only: tolerance 0.

- ``to_bytes`` of trees made from a numpy seed gives the JAX package's
  bytes, and each package's ``from_bytes`` reads the other's.
- Every ``ZExpr`` and ``ZCont`` variant, on fields from a numpy seed,
  gives the JAX ``z_ptr``, hash components and serde bytes.
- ``zstore_to_z_data`` gives the JAX bytes; the legacy strings, symbols
  and ``put_symbol(.lurk.nil)`` equal the port store's interning.
- Data of the wrong shape raises ``ValueError`` (the JAX readers
  assert).
"""

import numpy as np
import pytest

import lurk_tpu.store.z_data as jzd
import lurk_tpu.store.z_legacy as jzl
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.store.core import PoseidonMemo as JaxMemo
from lurk_tpu.store.core import ZPtr as JaxZPtr
from lurk_tpu.symbol import Symbol as JaxSymbol
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.store import z_data as zd
from lurk_tpu_torch.store import z_legacy as zl
from lurk_tpu_torch.store.core import PoseidonMemo, Store, ZPtr
from lurk_tpu_torch.symbol import Symbol
from lurk_tpu_torch.tags import ContTag, ExprTag, Op1, Op2
from test_torch_field import one_torch_thread  # noqa: F401

P = BN256_SCALAR.modulus


def rand_tree(rng, mod, depth=0):
    """A ZData tree of ``mod`` (either package's module) from ``rng``:
    atoms and cells of every tag class (0, small, 64, prefixed)."""
    if depth > 2 or rng.random() < 0.55:
        n = int(rng.choice([0, 1, 5, 63, 64, 65, 200, 300]))
        return mod.Atom(rng.bytes(n))
    n = int(rng.choice([0, 1, 3, 64, 65]))
    return mod.Cell([rand_tree(rng, mod, depth + 1) for _ in range(n)])


def to_port(z):
    """A JAX ZData tree as the port's."""
    if isinstance(z, jzd.Atom):
        return zd.Atom(z.bytes)
    return zd.Cell([to_port(c) for c in z.children])


@pytest.mark.parametrize("seed", range(4))
def test_zdata_bytes_match_jax(seed):
    trees = [rand_tree(np.random.default_rng(seed), jzd) for _ in range(25)]
    for jz in trees:
        z = to_port(jz)
        data = zd.to_bytes(z)
        assert data == jzd.to_bytes(jz)
        assert zd.from_bytes(data) == z
        assert to_port(jzd.from_bytes(data)) == z


def test_zdata_tags_and_codecs_match_jax():
    z = zd.Cell([zd.Atom(b"\x01"), zd.Atom(b"\x02\x03")])
    assert zd.to_bytes(z)[:2] == bytes([0b1100_0010, 0b0100_0001])
    for n in (0, 1, 63, 64, 65, 255, 256, 1 << 16, (1 << 64) - 1):
        assert zd.byte_count(n) == jzd.byte_count(n)
        assert zd.to_trimmed_le_bytes(n) == jzd.to_trimmed_le_bytes(n)
    rng = np.random.default_rng(7)
    for _ in range(10):
        f = int.from_bytes(rng.bytes(32), "little") % P
        a = zd.f_to_atom(f)
        assert a.bytes == jzd.f_to_atom(f).bytes and zd.atom_to_f(a) == f


def test_zdata_rejects_bad_prefixes():
    with pytest.raises(ValueError, match="too long"):
        zd.from_bytes(bytes([0b0000_1001]))
    with pytest.raises(ValueError, match="truncated"):
        zd.from_bytes(bytes([0b0000_0001]))
    with pytest.raises(ValueError, match="truncated"):
        zd.from_bytes(bytes([0b0100_0011, 1, 2]))


def variants(rng):
    """(ZExpr cases, ZCont cases) of both packages on the same fields:
    [(port object, JAX object)]."""
    def f():
        return int.from_bytes(rng.bytes(32), "little") % P

    def zp(tag):
        d = f()
        return ZPtr(tag, d), JaxZPtr(tag, d)

    def both(mod_port, mod_jax, variant, *fields):
        port = tuple(x[0] if isinstance(x, tuple) else x for x in fields)
        jax = tuple(x[1] if isinstance(x, tuple) else x for x in fields)
        return mod_port(variant, port), mod_jax(variant, jax)

    def ex(variant, *fields):
        return both(zl.ZExpr, jzl.ZExpr, variant, *fields)

    def co(variant, *fields):
        return both(zl.ZCont, jzl.ZCont, variant, *fields)

    cont = zp(ContTag.Outermost)
    exprs = [
        ex("Nil"), ex("RootSym"), ex("RootKey"), ex("EmptyStr"),
        ex("Cons", zp(ExprTag.Num), zp(ExprTag.Cons)),
        ex("Comm", f(), zp(ExprTag.Fun)),
        ex("Sym", zp(ExprTag.Str), zp(ExprTag.Sym)),
        ex("Key", zp(ExprTag.Str), zp(ExprTag.Key)),
        ex("Fun", zp(ExprTag.Sym), zp(ExprTag.Cons), zp(ExprTag.Env)),
        ex("Num", f()),
        ex("Str", zp(ExprTag.Char), zp(ExprTag.Str)),
        ex("Thunk", zp(ExprTag.Num), zp(ContTag.Tail)),
        ex("Char", chr(int(rng.integers(32, 0x2FFF)))),
        ex("UInt", int(rng.integers(0, 1 << 63))),
    ]
    conts = [
        co("Outermost"), co("Error"), co("Dummy"), co("Terminal"),
        co("Call0", zp(ExprTag.Env), cont),
        co("Call", zp(ExprTag.Env), zp(ExprTag.Num), cont),
        co("Call2", zp(ExprTag.Env), zp(ExprTag.Fun), cont),
        co("Tail", zp(ExprTag.Env), cont),
        co("Lookup", zp(ExprTag.Env), cont),
        co("Unop", Op1.Cdr, cont),
        co("Binop", Op2.Product, zp(ExprTag.Env), zp(ExprTag.Cons), cont),
        co("Binop2", Op2.Diff, zp(ExprTag.Num), cont),
        co("If", zp(ExprTag.Cons), cont),
        co("Let", zp(ExprTag.Sym), zp(ExprTag.Cons), zp(ExprTag.Env), cont),
        co("LetRec", zp(ExprTag.Sym), zp(ExprTag.Cons), zp(ExprTag.Env),
           cont),
        co("Emit", cont),
    ]
    return exprs, conts


@pytest.mark.parametrize("seed", range(2))
def test_every_variant_matches_jax(seed):
    """Each variant's z_ptr, hash components and serde bytes; the serde
    round trip through both packages' bytes."""
    exprs, conts = variants(np.random.default_rng(seed))
    memo, jmemo = PoseidonMemo(BN256_SCALAR), JaxMemo(JAX_BN256)
    assert len(exprs) == len(zl._ZEXPR_VARIANTS)
    assert len(conts) == len(zl._ZCONT_VARIANTS)
    for e, je in exprs:
        assert tuple(e.z_ptr(memo, BN256_SCALAR)) == \
            tuple(je.z_ptr(jmemo, JAX_BN256)), e.variant
        data = zd.to_bytes(zl.zexpr_to_z_data(e))
        assert data == jzd.to_bytes(jzl.zexpr_to_z_data(je)), e.variant
        assert zl.zexpr_from_z_data(zd.from_bytes(data)) == e
    for c, jc in conts:
        assert c.hash_components() == jc.hash_components(), c.variant
        assert tuple(c.z_ptr(memo)) == tuple(jc.z_ptr(jmemo)), c.variant
        data = zd.to_bytes(zl.zcont_to_z_data(c))
        assert data == jzd.to_bytes(jzl.zcont_to_z_data(jc)), c.variant
        assert zl.zcont_from_z_data(zd.from_bytes(data)) == c


def test_legacy_strings_and_symbols_match_the_store():
    """put_string / put_symbol reproduce the port store's interning, and
    ZExpr Nil (put_symbol(.lurk.nil)) the store's nil digest."""
    store = Store(BN256_SCALAR, device="cpu")
    memo, jmemo = PoseidonMemo(BN256_SCALAR), JaxMemo(JAX_BN256)
    zs, jzs = zl.ZStoreLegacy(), jzl.ZStoreLegacy()
    for s in ("", "a", "abc", "hello world"):
        ptr, _ = zs.put_string(s, memo, BN256_SCALAR)
        assert tuple(ptr) == tuple(store.hash_ptr(store.intern_string(s)))
        assert tuple(ptr) == tuple(jzs.put_string(s, jmemo, JAX_BN256)[0])
    path = ("lurk", "user", "square")
    ptr, _ = zs.put_symbol(Symbol(path), memo, BN256_SCALAR)
    want = store.hash_ptr(store.intern_symbol(Symbol(path)))
    assert ptr.digest == want.digest
    assert tuple(ptr) == tuple(jzs.put_symbol(JaxSymbol(path), jmemo,
                                              JAX_BN256)[0])
    nil = store.hash_ptr(store.intern_nil())
    assert tuple(zs.nil_z_ptr(memo, BN256_SCALAR)) == tuple(nil)
    assert tuple(zl.ZExpr("Nil").z_ptr(memo, BN256_SCALAR)) == tuple(nil)
    assert nil.tag == ExprTag.Nil


def test_zstore_bytes_match_jax():
    """A legacy store with symbols, strings, a continuation and an
    absent entry serializes to the JAX bytes and reads back; immediates
    resolve without map entries."""
    memo, jmemo = PoseidonMemo(BN256_SCALAR), JaxMemo(JAX_BN256)
    zs, jzs = zl.ZStoreLegacy(), jzl.ZStoreLegacy()
    for s, js, m, field in ((zs, Symbol, memo, BN256_SCALAR),
                            (jzs, JaxSymbol, jmemo, JAX_BN256)):
        s.put_symbol(js(("lurk", "user", "f")), m, field)
        s.put_string("chain", m, field)
    h80 = memo.hash((0,) * 8)
    zc = zl.ZCont("Emit", (ZPtr(ContTag.Outermost, h80),))
    jzc = jzl.ZCont("Emit", (JaxZPtr(ContTag.Outermost, h80),))
    zs.insert_z_cont(zc.z_ptr(memo), zc)
    jzs.insert_z_cont(jzc.z_ptr(jmemo), jzc)
    absent = ZPtr(ExprTag.Cons, 12345)
    zs.insert_z_expr(absent, None)
    jzs.insert_z_expr(JaxZPtr(ExprTag.Cons, 12345), None)
    data = zd.to_bytes(zl.zstore_to_z_data(zs))
    assert data == jzd.to_bytes(jzl.zstore_to_z_data(jzs))
    back = zl.zstore_from_z_data(zd.from_bytes(data))
    assert back.expr_map == zs.expr_map and back.cont_map == zs.cont_map
    assert back.get_expr(absent) is None and absent in back.expr_map
    assert back.get_expr(ZPtr(ExprTag.U64, 7)) == zl.ZExpr("UInt", (7,))
    assert back.get_expr(ZPtr(ExprTag.Str, 0)) == zl.ZExpr("EmptyStr")
    # z_store.rs:71, as the JAX package: Key(0) resolves to RootSym
    assert back.get_expr(ZPtr(ExprTag.Key, 0)) == zl.ZExpr("RootSym")


@pytest.mark.parametrize("reader, data", [
    (zl.zexpr_from_z_data, zd.Atom(b"\x00")),
    (zl.zcont_from_z_data, zd.Atom(b"\x00")),
    (zl.zstore_from_z_data, zd.Cell([zd.Cell([])])),
    (zl.zexpr_from_z_data, zd.Cell([zd.Atom(b"\x01"), zd.Atom(b"")])),
], ids=["expr-atom", "cont-atom", "store-one-cell", "cons-field-atom"])
def test_readers_raise_on_bad_shapes(reader, data):
    with pytest.raises(ValueError, match="expected a cell"):
        reader(data)
