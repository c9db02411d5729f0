"""The port's wasm interpreter and circom witness calculator
(``lurk_tpu_torch.coproc.wasm_interp`` / ``wasm_witness``) against the
JAX package's on the CPU. Integers only: tolerance 0.

- Every test of ``tests/test_wasm_interp.py`` runs with its ``W`` set to
  a pair of both interpreters: each module it builds is parsed and
  instantiated by both, every call of an export gives the same result
  or the same trap in both, and memory stays equal after each call.
- Edge cases of the integer semantics through both: i32/i64 wrapping,
  signed division and remainder (their traps and INT_MIN / -1), shifts
  and rotates by the full width, ``br_table`` past its targets,
  ``call_indirect`` through an empty slot and with the wrong type,
  ``memory.grow`` past the maximum, loads out of bounds.
- ``build_multiplier_wasm`` of ``tests/test_wasm_witness.py`` through
  both ``WitnessCalculator``s to the same witness, and through the
  port's ``CircomGadget`` with ``check_witness``.
"""

import struct

import pytest

import lurk_tpu.coproc.wasm_interp as jax_wasm
import lurk_tpu.coproc.wasm_witness as jax_witness
import test_wasm_interp
from lurk_tpu_torch.coproc import circom
from lurk_tpu_torch.coproc import wasm_interp as port_wasm
from lurk_tpu_torch.coproc import wasm_witness as port_witness
from test_wasm_interp import (
    END, I32, I64, LOCAL_GET, functype, i32c, module, section, uleb,
    vec,
)
from test_wasm_witness import P as MUL_P
from test_wasm_witness import build_multiplier_wasm

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def outcome(fn, *args):
    """("ok", result) or ("trap" / "error", message), the trap kinds
    named alike in both packages."""
    try:
        return "ok", fn(*args)
    except (jax_wasm.WasmTrap, port_wasm.WasmTrap) as e:
        return "trap", str(e)
    except (jax_wasm.WasmError, port_wasm.WasmError) as e:
        return "error", str(e)


class BothInstance:
    """A module instantiated by both interpreters; ``export`` calls
    both and holds their outcomes and memories equal."""

    def __init__(self, modules, imports=None):
        jax_mod, port_mod = modules
        self.jax = jax_wasm.Instance(jax_mod, imports)
        self.port = port_wasm.Instance(port_mod, imports)

    @property
    def mem(self):
        assert self.jax.mem == self.port.mem
        return self.port.mem

    def export(self, name):
        jf, pf = self.jax.export(name), self.port.export(name)

        def call(*args):
            got = outcome(pf, *args)
            assert got == outcome(jf, *args), (name, args)
            assert self.jax.mem == self.port.mem
            assert self.jax.globals == self.port.globals
            if got[0] == "trap":
                raise port_wasm.WasmTrap(got[1])
            if got[0] == "error":
                raise port_wasm.WasmError(got[1])
            return got[1]

        return call


class Both:
    """Stands in for ``test_wasm_interp``'s ``W``: both packages."""

    PAGE = port_wasm.PAGE
    WasmTrap = port_wasm.WasmTrap
    WasmError = port_wasm.WasmError
    Instance = BothInstance

    @staticmethod
    def parse_module(data):
        return jax_wasm.parse_module(data), port_wasm.parse_module(data)


INTERP_TESTS = [name for name in dir(test_wasm_interp)
                if name.startswith("test_")]


def test_every_interpreter_test_is_run():
    assert len(INTERP_TESTS) == 9


@pytest.mark.parametrize("name", INTERP_TESTS)
def test_interpreter_tests_through_both(name, monkeypatch):
    monkeypatch.setattr(test_wasm_interp, "W", Both)
    getattr(test_wasm_interp, name)()


def binop(ty, op):
    body = LOCAL_GET(0) + LOCAL_GET(1) + bytes([op]) + END
    return module(types=[functype([ty, ty], [ty if op < 0x46 or op > 0x5A
                                             else I32])],
                  funcs=[0], codes=[([], body)], exports=[("f", 0, 0)])


I32_EDGES = [0, 1, 2, 31, 32, 33, 0x7FFFFFFF, 0x80000000, M32, M32 - 1,
             12345678]
I64_EDGES = [0, 1, 2, 63, 64, 65, (1 << 63) - 1, 1 << 63, M64, M64 - 1,
             1 << 32, 0xDEADBEEFCAFEBABE]
# every i32 / i64 comparison and binary operation the interpreter has
I32_OPS = list(range(0x46, 0x50)) + list(range(0x6A, 0x79))
I64_OPS = list(range(0x51, 0x5B)) + list(range(0x7C, 0x8B))


@pytest.mark.parametrize("ty,ops,edges", [(I32, I32_OPS, I32_EDGES),
                                          (I64, I64_OPS, I64_EDGES)],
                         ids=["i32", "i64"])
def test_binary_ops_on_edge_values(ty, ops, edges):
    """Wrapping, signed division and remainder (by 0: a trap in both;
    INT_MIN / -1: the same value in both), shifts and rotates by the
    width and beyond, signed and unsigned comparisons."""
    traps = 0
    for op in ops:
        f = BothInstance(Both.parse_module(binop(ty, op))).export("f")
        for a in edges:
            for b in edges:
                try:
                    f(a, b)
                except port_wasm.WasmTrap:
                    traps += 1
    # div_s, div_u, rem_s, rem_u by 0, for every dividend
    assert traps == 4 * len(edges)


UNARY = [(I32, I32, op) for op in (0x45, 0x67, 0x68, 0x69, 0xC0, 0xC1)] + \
    [(I64, I32, 0x50), (I64, I32, 0xA7)] + \
    [(I64, I64, op) for op in (0x79, 0x7A, 0x7B, 0xC2, 0xC3, 0xC4)] + \
    [(I32, I64, 0xAC), (I32, I64, 0xAD)]


@pytest.mark.parametrize("src,dst,op", UNARY,
                         ids=[f"{op:#x}" for _, _, op in UNARY])
def test_unary_ops_on_edge_values(src, dst, op):
    body = LOCAL_GET(0) + bytes([op]) + END
    f = BothInstance(Both.parse_module(module(
        types=[functype([src], [dst])], funcs=[0], codes=[([], body)],
        exports=[("f", 0, 0)]))).export("f")
    for a in (I32_EDGES if src == I32 else I64_EDGES):
        f(a)


def test_control_flow_and_memory_traps():
    """``br_table`` past its targets takes the default; an empty table
    slot and a mistyped ``call_indirect`` trap; ``memory.grow`` past the
    maximum gives -1; a load past the end traps: alike in both."""
    # br_table with 2 targets on i in 0..5
    body = (bytes([0x02, 0x40]) * 3 + LOCAL_GET(0)
            + bytes([0x0E]) + uleb(2) + uleb(0) + uleb(1) + uleb(2)
            + END + i32c(10) + bytes([0x0F])
            + END + i32c(20) + bytes([0x0F])
            + END + i32c(30) + END)
    f = BothInstance(Both.parse_module(module(
        types=[functype([I32], [I32])], funcs=[0], codes=[([], body)],
        exports=[("f", 0, 0)]))).export("f")
    assert [f(i) for i in (0, 1, 2, 5, M32)] == [10, 20, 30, 30, 30]
    # call_indirect: slot 0 (i32, i32) -> i32, slot 1 (i32) -> i32,
    # slot 2 empty
    add = LOCAL_GET(0) + LOCAL_GET(1) + bytes([0x6A]) + END
    neg = i32c(0) + LOCAL_GET(0) + bytes([0x6B]) + END
    disp = (LOCAL_GET(1) + LOCAL_GET(2) + LOCAL_GET(0)
            + bytes([0x11]) + uleb(0) + uleb(0) + END)
    g = BothInstance(Both.parse_module(module(
        types=[functype([I32, I32], [I32]), functype([I32], [I32]),
               functype([I32, I32, I32], [I32])],
        funcs=[0, 1, 2], codes=[([], add), ([], neg), ([], disp)],
        exports=[("g", 0, 2)], tables=3,
        elems=[(i32c(0) + END, [0, 1])]))).export("g")
    assert g(0, M32, 2) == 1
    for slot, why in ((1, "indirect type mismatch"),
                      (2, "bad indirect call"), (7, "bad indirect call")):
        with pytest.raises(port_wasm.WasmTrap, match=why):
            g(slot, 1, 2)
    # memory.grow with a maximum of 2 pages; i64.load at the end
    grow = LOCAL_GET(0) + bytes([0x40, 0x00]) + END
    load = LOCAL_GET(0) + bytes([0x29]) + uleb(3) + uleb(0) + END
    wasm = module(types=[functype([I32], [I32]), functype([I32], [I64])],
                  funcs=[0, 1], codes=[([], grow), ([], load)],
                  exports=[("grow", 0, 0), ("load", 0, 1)], mem_pages=1)
    no_max = section(5, vec([bytes([0]) + uleb(1)]))
    assert wasm.count(no_max) == 1
    inst = BothInstance(Both.parse_module(wasm.replace(
        no_max, section(5, vec([bytes([1]) + uleb(1) + uleb(2)])))))
    grow_f, load_f = inst.export("grow"), inst.export("load")
    assert grow_f(2) == M32 and grow_f(1) == 1 and grow_f(1) == M32
    assert len(inst.mem) == 2 * port_wasm.PAGE
    assert load_f(2 * port_wasm.PAGE - 8) == 0
    with pytest.raises(port_wasm.WasmTrap, match="oob load"):
        load_f(2 * port_wasm.PAGE - 7)


def test_decoder_errors_alike():
    for data in (b"\0asX" + struct.pack("<I", 1), b"\0asm" +
                 struct.pack("<I", 2), b"\0asm" + struct.pack("<I", 1)
                 + bytes([1, 4, 1, 0x61, 0, 0])):
        assert outcome(port_wasm.parse_module, data)[0] == "error"
        assert outcome(port_wasm.parse_module, data) == \
            outcome(jax_wasm.parse_module, data)


def test_multiplier_witness_through_both_calculators():
    wasm = build_multiplier_wasm()
    calcs = (jax_witness.WitnessCalculator(wasm),
             port_witness.WitnessCalculator(wasm))
    assert [(c.n32, c.prime) for c in calcs] == [(1, MUL_P)] * 2
    assert port_witness.fnv1a_64("in") == jax_witness.fnv1a_64("in")
    for inputs in ({"a": [123456], "b": [9876]}, {"b": 3, "a": MUL_P - 1},
                   {"a": [MUL_P + 5], "b": [M32]}):
        w = calcs[1].calculate_witness(inputs)
        assert w == calcs[0].calculate_witness(inputs)
        a, b = (int(v if isinstance(v, int) else v[0]) % MUL_P
                for v in (inputs["a"], inputs["b"]))
        assert w == [1, a * b % MUL_P, a, b]


def test_multiplier_through_the_ports_gadget(tmp_path):
    wasm = tmp_path / "mul.wasm"
    wasm.write_bytes(build_multiplier_wasm())
    r1cs = circom.R1cs(prime=MUL_P, n_wires=4, n_pub_out=1, n_pub_in=0,
                       n_prv_in=2, n_labels=4,
                       constraints=[({2: 1}, {3: 1}, {1: 1})])
    (tmp_path / "not.wasm").write_bytes(b"not a wasm module")
    gadget = circom.CircomGadget("test/mul", r1cs,
                                 wasm_path=str(tmp_path / "not.wasm"))
    with pytest.raises(port_wasm.WasmError, match="bad magic"):
        gadget.calculate_witness({"a": [1], "b": [2]})
    gadget = circom.CircomGadget("test/mul", r1cs, wasm_path=str(wasm))
    w = gadget.calculate_witness({"a": [777], "b": [1001]})
    assert w == [1, 777 * 1001 % MUL_P, 777, 1001]
    assert gadget.check_witness(w)
    bad = list(w)
    bad[1] = (bad[1] + 1) % MUL_P
    assert not gadget.check_witness(bad)
    # a calculator over another prime than the r1cs's is refused
    other = circom.CircomGadget("test/mul", circom.R1cs(
        MUL_P - 2, 4, 1, 0, 2, 4, r1cs.constraints), wasm_path=str(wasm))
    with pytest.raises(ValueError, match="wasm field"):
        other.calculate_witness({"a": [1], "b": [2]})
