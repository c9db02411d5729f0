"""Minimal WebAssembly interpreter (MVP integer subset) for circom
witness calculators.

The port's own copy of the JAX package's ``coproc/wasm_interp.py``:
host Python, no torch. The reference loads circom gadgets through
`circom-scotia`, whose witness generation executes the circom-compiled
`<name>.wasm` module (reference src/coprocessor/circom/mod.rs:9-51).
With no node or wasmer to shell out to, this module interprets the wasm
binary directly. circom-generated witness calculators use only the MVP
integer feature set — i32/i64 arithmetic, linear memory, globals,
structured control flow, direct/indirect calls — no floats (fr.wasm
arithmetic is 32-bit-limb bignum code), no SIMD, no reference types
beyond funcref tables. Unsupported opcodes raise WasmError.

Integer semantics are the JAX package's bit for bit: i32/i64 wrapping,
signed division and remainder with their traps, ``br_table``,
``call_indirect`` and ``memory.grow`` (held against it by
``tests/test_torch_wasm.py``). This is a from-scratch implementation of
the wasm spec's execution semantics (decode -> in-place structured
interpretation with a value stack); nothing here derives from any
existing engine.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, List, Optional, Tuple


class WasmError(Exception):
    pass


class WasmTrap(WasmError):
    pass


# ---------------------------------------------------------------------------
# binary decoding
# ---------------------------------------------------------------------------


class Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def bytes(self, n: int) -> bytes:
        v = self.b[self.i:self.i + n]
        if len(v) != n:
            raise WasmError("truncated")
        self.i += n
        return v

    def uleb(self) -> int:
        r = 0
        s = 0
        while True:
            c = self.u8()
            r |= (c & 0x7F) << s
            if not (c & 0x80):
                return r
            s += 7

    def sleb(self, bits: int) -> int:
        r = 0
        s = 0
        while True:
            c = self.u8()
            r |= (c & 0x7F) << s
            s += 7
            if not (c & 0x80):
                if s < bits and (c & 0x40):
                    r |= -1 << s
                return r

    def name(self) -> str:
        n = self.uleb()
        return self.bytes(n).decode("utf-8")

    def eof(self) -> bool:
        return self.i >= len(self.b)


@dataclasses.dataclass
class FuncType:
    params: Tuple[int, ...]
    results: Tuple[int, ...]


@dataclasses.dataclass
class Func:
    type_idx: int
    locals: List[int]            # expanded local value types
    body: bytes                  # code (ends with 0x0B)
    jumps: Dict[int, tuple]      # structured-op offsets (see _scan)


@dataclasses.dataclass
class Module:
    types: List[FuncType]
    imports: List[tuple]         # (module, name, kind, desc)
    funcs: List[int]             # type indices of local functions
    tables: List[tuple]
    mem_min: int
    mem_max: Optional[int]
    globals_init: List[tuple]    # (valtype, mutable, init_expr_bytes)
    exports: Dict[str, Tuple[str, int]]
    start: Optional[int]
    elems: List[tuple]           # (table_idx, offset_expr, func_idxs)
    codes: List[Func]
    datas: List[tuple]           # (offset_expr, bytes)
    n_imported_funcs: int
    n_imported_globals: int


def parse_module(data: bytes) -> Module:
    r = Reader(data)
    if r.bytes(4) != b"\0asm":
        raise WasmError("bad magic")
    if struct.unpack("<I", r.bytes(4))[0] != 1:
        raise WasmError("unsupported wasm version")
    types: List[FuncType] = []
    imports: List[tuple] = []
    funcs: List[int] = []
    tables: List[tuple] = []
    mem_min, mem_max = 0, None
    globals_init: List[tuple] = []
    exports: Dict[str, Tuple[str, int]] = {}
    start = None
    elems: List[tuple] = []
    codes: List[Func] = []
    datas: List[tuple] = []

    def read_limits(rr):
        flag = rr.u8()
        lo = rr.uleb()
        hi = rr.uleb() if flag & 1 else None
        return lo, hi

    def read_expr(rr) -> bytes:
        """Const init expr: bytes up to and including the 0x0B end."""
        start_i = rr.i
        depth = 0
        while True:
            op = rr.u8()
            if op == 0x0B:
                if depth == 0:
                    return rr.b[start_i:rr.i]
                depth -= 1
            elif op in (0x02, 0x03, 0x04):
                depth += 1
                rr.u8()
            elif op in (0x41,):
                rr.sleb(32)
            elif op in (0x42,):
                rr.sleb(64)
            elif op == 0x23:
                rr.uleb()
            else:
                raise WasmError(f"unsupported init op {op:#x}")

    while not r.eof():
        sec = r.u8()
        size = r.uleb()
        body = Reader(r.bytes(size))
        if sec == 1:
            for _ in range(body.uleb()):
                if body.u8() != 0x60:
                    raise WasmError("bad functype")
                np = body.uleb()
                params = tuple(body.u8() for _ in range(np))
                nr = body.uleb()
                results = tuple(body.u8() for _ in range(nr))
                types.append(FuncType(params, results))
        elif sec == 2:
            for _ in range(body.uleb()):
                mod = body.name()
                nm = body.name()
                kind = body.u8()
                if kind == 0:
                    desc = body.uleb()
                elif kind == 1:
                    body.u8()
                    desc = read_limits(body)
                elif kind == 2:
                    desc = read_limits(body)
                elif kind == 3:
                    desc = (body.u8(), body.u8())
                else:
                    raise WasmError("bad import kind")
                imports.append((mod, nm, kind, desc))
        elif sec == 3:
            for _ in range(body.uleb()):
                funcs.append(body.uleb())
        elif sec == 4:
            for _ in range(body.uleb()):
                body.u8()                       # elemtype (funcref)
                tables.append(read_limits(body))
        elif sec == 5:
            for _ in range(body.uleb()):
                mem_min, mem_max = read_limits(body)
        elif sec == 6:
            for _ in range(body.uleb()):
                vt = body.u8()
                mut = body.u8()
                globals_init.append((vt, mut, read_expr(body)))
        elif sec == 7:
            for _ in range(body.uleb()):
                nm = body.name()
                kind = body.u8()
                idx = body.uleb()
                exports[nm] = (("func", "table", "mem", "global")[kind],
                               idx)
        elif sec == 8:
            start = body.uleb()
        elif sec == 9:
            for _ in range(body.uleb()):
                ti = body.uleb()
                off = read_expr(body)
                n = body.uleb()
                elems.append((ti, off, [body.uleb() for _ in range(n)]))
        elif sec == 10:
            for _ in range(body.uleb()):
                sz = body.uleb()
                code = Reader(body.bytes(sz))
                locs: List[int] = []
                for _ in range(code.uleb()):
                    cnt = code.uleb()
                    vt = code.u8()
                    locs.extend([vt] * cnt)
                codes.append(Func(0, locs, code.b[code.i:], {}))
        elif sec == 11:
            for _ in range(body.uleb()):
                mi = body.uleb()
                if mi != 0:
                    raise WasmError("multi-memory unsupported")
                off = read_expr(body)
                n = body.uleb()
                datas.append((off, bytes(body.bytes(n))))
        # sections 0 (custom) and others: skipped
    n_if = sum(1 for im in imports if im[2] == 0)
    n_ig = sum(1 for im in imports if im[2] == 3)
    for i, f in enumerate(codes):
        f.type_idx = funcs[i]
        f.jumps = _scan(f.body)
    return Module(types, imports, funcs, tables, mem_min, mem_max,
                  globals_init, exports, start, elems, codes, datas,
                  n_if, n_ig)


# ---------------------------------------------------------------------------
# pre-scan: match block/loop/if to their end/else offsets
# ---------------------------------------------------------------------------

_MEM_OPS = set(range(0x28, 0x3F))       # loads/stores (have 2 uleb args)


def _skip_imm(r: Reader, op: int) -> None:
    if op in (0x41,):
        r.sleb(32)
    elif op in (0x42,):
        r.sleb(64)
    elif op in (0x43,):
        r.bytes(4)
    elif op in (0x44,):
        r.bytes(8)
    elif op in (0x0C, 0x0D, 0x10, 0x20, 0x21, 0x22, 0x23, 0x24):
        r.uleb()
    elif op == 0x11:
        r.uleb()
        r.uleb()
    elif op == 0x0E:
        n = r.uleb()
        for _ in range(n + 1):
            r.uleb()
    elif op in _MEM_OPS:
        r.uleb()
        r.uleb()
    elif op in (0x3F, 0x40):
        r.u8()
    elif op == 0xFC:
        sub = r.uleb()
        if sub in (0, 1, 2, 3, 4, 5, 6, 7):
            pass
        elif sub in (8, 9, 10, 11, 12, 13, 14, 15, 16, 17):
            r.uleb()
            if sub in (8, 10, 12, 14):
                r.uleb()
        else:
            raise WasmError(f"unsupported 0xFC {sub}")


def _scan(body: bytes) -> Dict[int, tuple]:
    """offset-of-structured-op -> (end_offset, else_offset|None).
    Offsets point AT the op byte; end/else offsets point AFTER the
    end/else byte."""
    r = Reader(body)
    stack: List[Tuple[int, Optional[int]]] = []
    jumps: Dict[int, tuple] = {}
    while not r.eof():
        at = r.i
        op = r.u8()
        if op in (0x02, 0x03, 0x04):            # block/loop/if
            bt = r.u8()
            if bt == 0x7D or bt == 0x7C or bt == 0x7E or bt == 0x7F \
                    or bt == 0x40:
                pass
            else:
                # value-type or (unsupported) type-index blocktype
                raise WasmError("multi-value block types unsupported")
            stack.append((at, None))
        elif op == 0x05:                        # else
            bat, _ = stack.pop()
            stack.append((bat, r.i))
        elif op == 0x0B:                        # end
            if stack:
                bat, els = stack.pop()
                jumps[bat] = (r.i, els)
        else:
            _skip_imm(r, op)
    return jumps


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

PAGE = 65536
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _s32(v):
    v &= _M32
    return v - (1 << 32) if v & 0x80000000 else v


def _s64(v):
    v &= _M64
    return v - (1 << 64) if v & (1 << 63) else v


class Instance:
    """An instantiated module. `imports` maps (module, name) -> python
    callable for function imports."""

    def __init__(self, module: Module,
                 imports: Optional[Dict[Tuple[str, str], Callable]] = None):
        m = module
        self.m = m
        self.import_funcs: List[Callable] = []
        im_mem = None
        self.import_types: List[int] = []
        for mod, nm, kind, desc in m.imports:
            if kind == 0:
                fn = (imports or {}).get((mod, nm))
                if fn is None:
                    ty = m.types[desc]
                    fn = _missing_import(mod, nm, ty)
                self.import_funcs.append(fn)
                self.import_types.append(desc)
            elif kind == 2:
                im_mem = desc
        pages = m.mem_min if im_mem is None else im_mem[0]
        self.mem = bytearray(pages * PAGE)
        self.mem_max = m.mem_max
        self.globals: List[int] = []
        for vt, mut, expr in m.globals_init:
            self.globals.append(self._const_expr(expr))
        self.table: List[Optional[int]] = []
        if m.tables:
            self.table = [None] * m.tables[0][0]
        for ti, off_expr, idxs in m.elems:
            off = self._const_expr(off_expr)
            need = off + len(idxs)
            if need > len(self.table):
                self.table.extend([None] * (need - len(self.table)))
            for k, fi in enumerate(idxs):
                self.table[off + k] = fi
        for off_expr, blob in m.datas:
            off = self._const_expr(off_expr)
            self.mem[off:off + len(blob)] = blob
        if m.start is not None:
            self.call_index(m.start, [])

    # -- helpers -------------------------------------------------------------

    def _const_expr(self, expr: bytes) -> int:
        r = Reader(expr)
        op = r.u8()
        if op == 0x41:
            return r.sleb(32) & _M32
        if op == 0x42:
            return r.sleb(64) & _M64
        if op == 0x23:
            return self.globals[r.uleb()]
        raise WasmError("unsupported const expr")

    def export(self, name: str) -> Callable:
        kind, idx = self.m.exports[name]
        if kind != "func":
            raise WasmError(f"{name} is not a function export")

        def call(*args):
            return self.call_index(idx, list(args))

        return call

    def memory_export(self) -> bytearray:
        return self.mem

    def call_index(self, idx: int, args: List[int]):
        nif = self.m.n_imported_funcs
        if idx < nif:
            res = self.import_funcs[idx](*args)
            if res is None:
                return None
            return res
        f = self.m.codes[idx - nif]
        ty = self.m.types[f.type_idx]
        rets = self._exec(f, args)
        if not ty.results:
            return None
        if len(ty.results) == 1:
            return rets[0]
        return tuple(rets)

    # -- the interpreter loop -------------------------------------------------

    def _exec(self, f: Func, args: List[int]) -> List[int]:
        m = self.m
        mem = self.mem
        ty = m.types[f.type_idx]
        locals_ = list(args) + [0] * len(f.locals)
        stack: List[int] = []
        # control stack entries: (kind, end_off, else_off, stack_height,
        #                         arity) — kind 'b'lock/'l'oop/'i'f
        ctrl: List[tuple] = []
        body = f.body
        jumps = f.jumps
        r = Reader(body)
        G = self.globals

        while True:
            op = r.u8()
            if op == 0x00:
                raise WasmTrap("unreachable")
            elif op == 0x01:
                pass
            elif op in (0x02, 0x03):            # block / loop
                at = r.i - 1
                bt = r.u8()
                ar = 0 if bt == 0x40 else 1
                end, _ = jumps[at]
                if op == 0x02:
                    ctrl.append(("b", end, None, len(stack), ar))
                else:
                    ctrl.append(("l", at, None, len(stack), ar))
            elif op == 0x04:                    # if
                at = r.i - 1
                bt = r.u8()
                ar = 0 if bt == 0x40 else 1
                end, els = jumps[at]
                c = stack.pop()
                ctrl.append(("b", end, None, len(stack), ar))
                if not (c & _M32):
                    if els is not None:
                        r.i = els
                    else:
                        r.i = end
                        ctrl.pop()
            elif op == 0x05:                    # else (end of then-branch)
                kind, end, _e, h, ar = ctrl.pop()
                vals = stack[len(stack) - ar:] if ar else []
                del stack[h:]
                stack.extend(vals)
                r.i = end
            elif op == 0x0B:                    # end
                if ctrl:
                    ctrl.pop()
                else:
                    nres = len(ty.results)
                    return stack[len(stack) - nres:] if nres else []
            elif op == 0x0C:                    # br
                d = r.uleb()
                _do_br(self, r, stack, ctrl, d, jumps)
            elif op == 0x0D:                    # br_if
                d = r.uleb()
                if stack.pop() & _M32:
                    _do_br(self, r, stack, ctrl, d, jumps)
            elif op == 0x0E:                    # br_table
                n = r.uleb()
                targets = [r.uleb() for _ in range(n)]
                default = r.uleb()
                k = stack.pop() & _M32
                d = targets[k] if k < n else default
                _do_br(self, r, stack, ctrl, d, jumps)
            elif op == 0x0F:                    # return
                nres = len(ty.results)
                return stack[len(stack) - nres:] if nres else []
            elif op == 0x10:                    # call
                fi = r.uleb()
                _do_call(self, stack, fi)
            elif op == 0x11:                    # call_indirect
                ti = r.uleb()
                r.uleb()
                k = stack.pop() & _M32
                if k >= len(self.table) or self.table[k] is None:
                    raise WasmTrap("bad indirect call")
                fi = self.table[k]
                ft = m.types[m.funcs[fi - m.n_imported_funcs]] \
                    if fi >= m.n_imported_funcs else None
                if ft is not None and ft != m.types[ti]:
                    raise WasmTrap("indirect type mismatch")
                _do_call(self, stack, fi)
            elif op == 0x1A:                    # drop
                stack.pop()
            elif op == 0x1B:                    # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c & _M32 else b)
            elif op == 0x20:
                stack.append(locals_[r.uleb()])
            elif op == 0x21:
                locals_[r.uleb()] = stack.pop()
            elif op == 0x22:
                locals_[r.uleb()] = stack[-1]
            elif op == 0x23:
                stack.append(G[r.uleb()])
            elif op == 0x24:
                G[r.uleb()] = stack.pop()
            elif 0x28 <= op <= 0x35:            # loads
                r.uleb()
                off = r.uleb()
                a = (stack.pop() & _M32) + off
                width = {0x28: 4, 0x29: 8, 0x2C: 1, 0x2D: 1, 0x2E: 2,
                         0x2F: 2, 0x30: 1, 0x31: 1, 0x32: 2, 0x33: 2,
                         0x34: 4, 0x35: 4}.get(op)
                if width is None:
                    raise WasmError(f"float load {op:#x} unsupported")
                if a + width > len(mem):
                    raise WasmTrap("oob load")
                try:
                    if op == 0x28:              # i32.load
                        v = int.from_bytes(mem[a:a + 4], "little")
                    elif op == 0x29:            # i64.load
                        v = int.from_bytes(mem[a:a + 8], "little")
                    elif op == 0x2C:            # i32.load8_s
                        v = mem[a]
                        v = v - 256 if v & 0x80 else v
                        v &= _M32
                    elif op == 0x2D:            # i32.load8_u
                        v = mem[a]
                    elif op == 0x2E:            # i32.load16_s
                        v = int.from_bytes(mem[a:a + 2], "little")
                        v = v - 65536 if v & 0x8000 else v
                        v &= _M32
                    elif op == 0x2F:            # i32.load16_u
                        v = int.from_bytes(mem[a:a + 2], "little")
                    elif op == 0x30:            # i64.load8_s
                        v = mem[a]
                        v = (v - 256 if v & 0x80 else v) & _M64
                    elif op == 0x31:
                        v = mem[a]
                    elif op == 0x32:            # i64.load16_s
                        v = int.from_bytes(mem[a:a + 2], "little")
                        v = (v - 65536 if v & 0x8000 else v) & _M64
                    elif op == 0x33:
                        v = int.from_bytes(mem[a:a + 2], "little")
                    elif op == 0x34:            # i64.load32_s
                        v = int.from_bytes(mem[a:a + 4], "little")
                        v = (v - (1 << 32) if v & 0x80000000 else v) & _M64
                    elif op == 0x35:
                        v = int.from_bytes(mem[a:a + 4], "little")
                    else:
                        raise WasmError(f"float load {op:#x} unsupported")
                except IndexError:
                    raise WasmTrap("oob load")
                stack.append(v)
            elif 0x36 <= op <= 0x3E:            # stores
                r.uleb()
                off = r.uleb()
                v = stack.pop()
                a = (stack.pop() & _M32) + off
                swidth = {0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1,
                          0x3D: 2, 0x3E: 4}.get(op)
                if swidth is None:
                    raise WasmError(f"float store {op:#x} unsupported")
                if a + swidth > len(mem):
                    raise WasmTrap("oob store")
                if op == 0x36:
                    mem[a:a + 4] = (v & _M32).to_bytes(4, "little")
                elif op == 0x37:
                    mem[a:a + 8] = (v & _M64).to_bytes(8, "little")
                elif op == 0x3A:
                    mem[a] = v & 0xFF
                elif op == 0x3B:
                    mem[a:a + 2] = (v & 0xFFFF).to_bytes(2, "little")
                elif op == 0x3C:
                    mem[a] = v & 0xFF
                elif op == 0x3D:
                    mem[a:a + 2] = (v & 0xFFFF).to_bytes(2, "little")
                elif op == 0x3E:
                    mem[a:a + 4] = (v & _M32).to_bytes(4, "little")
                else:
                    raise WasmError(f"float store {op:#x} unsupported")
            elif op == 0x3F:                    # memory.size
                r.u8()
                stack.append(len(mem) // PAGE)
            elif op == 0x40:                    # memory.grow
                r.u8()
                delta = stack.pop() & _M32
                old = len(mem) // PAGE
                new = old + delta
                if self.mem_max is not None and new > self.mem_max:
                    stack.append(_M32)          # -1
                else:
                    mem.extend(bytes(delta * PAGE))
                    stack.append(old)
            elif op == 0x41:
                stack.append(r.sleb(32) & _M32)
            elif op == 0x42:
                stack.append(r.sleb(64) & _M64)
            elif op == 0x45:                    # i32.eqz
                stack.append(1 if (stack.pop() & _M32) == 0 else 0)
            elif 0x46 <= op <= 0x4F:            # i32 comparisons
                b = stack.pop() & _M32
                a = stack.pop() & _M32
                sa, sb = _s32(a), _s32(b)
                v = {0x46: a == b, 0x47: a != b, 0x48: sa < sb,
                     0x49: a < b, 0x4A: sa > sb, 0x4B: a > b,
                     0x4C: sa <= sb, 0x4D: a <= b, 0x4E: sa >= sb,
                     0x4F: a >= b}[op]
                stack.append(1 if v else 0)
            elif op == 0x50:                    # i64.eqz
                stack.append(1 if (stack.pop() & _M64) == 0 else 0)
            elif 0x51 <= op <= 0x5A:            # i64 comparisons
                b = stack.pop() & _M64
                a = stack.pop() & _M64
                sa, sb = _s64(a), _s64(b)
                v = {0x51: a == b, 0x52: a != b, 0x53: sa < sb,
                     0x54: a < b, 0x55: sa > sb, 0x56: a > b,
                     0x57: sa <= sb, 0x58: a <= b, 0x59: sa >= sb,
                     0x5A: a >= b}[op]
                stack.append(1 if v else 0)
            elif op == 0x67:                    # i32.clz
                a = stack.pop() & _M32
                stack.append(32 - a.bit_length() if a else 32)
            elif op == 0x68:                    # i32.ctz
                a = stack.pop() & _M32
                stack.append((a & -a).bit_length() - 1 if a else 32)
            elif op == 0x69:                    # i32.popcnt
                stack.append(bin(stack.pop() & _M32).count("1"))
            elif 0x6A <= op <= 0x78:            # i32 arithmetic
                b = stack.pop() & _M32
                a = stack.pop() & _M32
                if op == 0x6A:
                    v = a + b
                elif op == 0x6B:
                    v = a - b
                elif op == 0x6C:
                    v = a * b
                elif op == 0x6D:                # div_s
                    if b == 0:
                        raise WasmTrap("div0")
                    sa, sb = _s32(a), _s32(b)
                    q = abs(sa) // abs(sb)
                    v = q if (sa < 0) == (sb < 0) else -q
                elif op == 0x6E:                # div_u
                    if b == 0:
                        raise WasmTrap("div0")
                    v = a // b
                elif op == 0x6F:                # rem_s
                    if b == 0:
                        raise WasmTrap("rem0")
                    sa, sb = _s32(a), _s32(b)
                    v = abs(sa) % abs(sb)
                    v = -v if sa < 0 else v
                elif op == 0x70:
                    if b == 0:
                        raise WasmTrap("rem0")
                    v = a % b
                elif op == 0x71:
                    v = a & b
                elif op == 0x72:
                    v = a | b
                elif op == 0x73:
                    v = a ^ b
                elif op == 0x74:
                    v = a << (b % 32)
                elif op == 0x75:
                    v = _s32(a) >> (b % 32)
                elif op == 0x76:
                    v = a >> (b % 32)
                elif op == 0x77:                # rotl
                    s = b % 32
                    v = (a << s) | (a >> (32 - s)) if s else a
                else:                           # rotr
                    s = b % 32
                    v = (a >> s) | (a << (32 - s)) if s else a
                stack.append(v & _M32)
            elif op == 0x79:                    # i64.clz
                a = stack.pop() & _M64
                stack.append(64 - a.bit_length() if a else 64)
            elif op == 0x7A:
                a = stack.pop() & _M64
                stack.append((a & -a).bit_length() - 1 if a else 64)
            elif op == 0x7B:
                stack.append(bin(stack.pop() & _M64).count("1"))
            elif 0x7C <= op <= 0x8A:            # i64 arithmetic
                b = stack.pop() & _M64
                a = stack.pop() & _M64
                if op == 0x7C:
                    v = a + b
                elif op == 0x7D:
                    v = a - b
                elif op == 0x7E:
                    v = a * b
                elif op == 0x7F:
                    if b == 0:
                        raise WasmTrap("div0")
                    sa, sb = _s64(a), _s64(b)
                    q = abs(sa) // abs(sb)
                    v = q if (sa < 0) == (sb < 0) else -q
                elif op == 0x80:
                    if b == 0:
                        raise WasmTrap("div0")
                    v = a // b
                elif op == 0x81:
                    if b == 0:
                        raise WasmTrap("rem0")
                    sa, sb = _s64(a), _s64(b)
                    v = abs(sa) % abs(sb)
                    v = -v if sa < 0 else v
                elif op == 0x82:
                    if b == 0:
                        raise WasmTrap("rem0")
                    v = a % b
                elif op == 0x83:
                    v = a & b
                elif op == 0x84:
                    v = a | b
                elif op == 0x85:
                    v = a ^ b
                elif op == 0x86:
                    v = a << (b % 64)
                elif op == 0x87:
                    v = _s64(a) >> (b % 64)
                elif op == 0x88:
                    v = a >> (b % 64)
                elif op == 0x89:
                    s = b % 64
                    v = (a << s) | (a >> (64 - s)) if s else a
                else:
                    s = b % 64
                    v = (a >> s) | (a << (64 - s)) if s else a
                stack.append(v & _M64)
            elif op == 0xA7:                    # i32.wrap_i64
                stack.append(stack.pop() & _M32)
            elif op == 0xAC:                    # i64.extend_i32_s
                stack.append(_s32(stack.pop()) & _M64)
            elif op == 0xAD:                    # i64.extend_i32_u
                stack.append(stack.pop() & _M32)
            elif op == 0xC0:                    # i32.extend8_s
                a = stack.pop() & 0xFF
                stack.append((a - 256 if a & 0x80 else a) & _M32)
            elif op == 0xC1:                    # i32.extend16_s
                a = stack.pop() & 0xFFFF
                stack.append((a - 65536 if a & 0x8000 else a) & _M32)
            elif op == 0xC2:                    # i64.extend8_s
                a = stack.pop() & 0xFF
                stack.append((a - 256 if a & 0x80 else a) & _M64)
            elif op == 0xC3:
                a = stack.pop() & 0xFFFF
                stack.append((a - 65536 if a & 0x8000 else a) & _M64)
            elif op == 0xC4:                    # i64.extend32_s
                a = stack.pop() & _M32
                stack.append((a - (1 << 32) if a & 0x80000000 else a)
                             & _M64)
            elif op == 0xFC:
                sub = r.uleb()
                if sub == 10:                   # memory.copy
                    r.uleb()
                    r.uleb()
                    n = stack.pop() & _M32
                    s = stack.pop() & _M32
                    d = stack.pop() & _M32
                    mem[d:d + n] = bytes(mem[s:s + n])
                elif sub == 11:                 # memory.fill
                    r.uleb()
                    n = stack.pop() & _M32
                    val = stack.pop() & 0xFF
                    d = stack.pop() & _M32
                    mem[d:d + n] = bytes([val]) * n
                else:
                    raise WasmError(f"0xFC {sub} unsupported")
            else:
                raise WasmError(f"opcode {op:#x} unsupported")


def _do_br(inst, r, stack, ctrl, depth, jumps):
    target = ctrl[-1 - depth]
    kind, pos, _els, h, ar = target
    if kind == "l":
        del stack[h:]
        del ctrl[len(ctrl) - depth - 1:]
        # re-enter the loop: re-execute its opening op to re-push ctrl
        r.i = pos
        op = r.u8()
        assert op == 0x03
        r.u8()
        ctrl.append(("l", pos, None, len(stack), ar))
    else:
        vals = stack[len(stack) - ar:] if ar else []
        del stack[h:]
        stack.extend(vals)
        del ctrl[len(ctrl) - depth - 1:]
        r.i = pos


def _do_call(inst, stack, fi):
    m = inst.m
    if fi < m.n_imported_funcs:
        ty = m.types[inst.import_types[fi]]
        n = len(ty.params)
        args = stack[len(stack) - n:] if n else []
        del stack[len(stack) - n:]
        res = inst.import_funcs[fi](*args)
        if ty.results:
            stack.append((res if res is not None else 0)
                         & (_M32 if ty.results[0] == 0x7F else _M64))
        return
    f = m.codes[fi - m.n_imported_funcs]
    ty = m.types[f.type_idx]
    n = len(ty.params)
    args = stack[len(stack) - n:] if n else []
    del stack[len(stack) - n:]
    rets = inst._exec(f, args)
    stack.extend(rets)


def _missing_import(mod: str, nm: str, ty: FuncType) -> Callable:
    def stub(*args):
        if ty.results:
            return 0
        return None

    return stub
