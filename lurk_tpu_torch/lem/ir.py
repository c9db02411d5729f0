"""LEM (Lurk Evaluation Model) intermediate representation.

LEM is a first-order, referentially transparent SSA-style IR in which the
Lurk step function is authored once; both the interpreter (witness/hint
generator, :mod:`lurk_tpu_torch.lem.interpreter`) and the R1CS circuit
(``lem.circuit``, ported in a later slice) are derived from it automatically.

Parity: reference src/lem/mod.rs:90-296 (types and static checks).
The quasi-Lisp `func!` macros of the reference (src/lem/macros.rs) are
replaced by plain Python constructor helpers in
:mod:`lurk_tpu_torch.lem.eval_step`.

Ops are flat tuples (kind, ...) for cheap interpretation; `Ctrl` nodes are
small dataclasses. Variables are plain strings; `Func.deconflict` performs
the SSA renaming pass so that circuit synthesis never sees shadowing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..symbol import Symbol

# ---------------------------------------------------------------------------
# Literals
# ---------------------------------------------------------------------------

LIT_NUM = "num"
LIT_STRING = "string"
LIT_SYMBOL = "symbol"


@dataclasses.dataclass(frozen=True)
class Lit:
    kind: str           # LIT_NUM | LIT_STRING | LIT_SYMBOL
    value: Union[int, str, Symbol]

    @staticmethod
    def num(v: int) -> "Lit":
        return Lit(LIT_NUM, v)

    @staticmethod
    def string(s: str) -> "Lit":
        return Lit(LIT_STRING, s)

    @staticmethod
    def symbol(s: Symbol) -> "Lit":
        return Lit(LIT_SYMBOL, s)


# ---------------------------------------------------------------------------
# Ops: (OP_KIND, args...) tuples. Layout documented per kind.
# ---------------------------------------------------------------------------

# (CPROC, out_vars: tuple, sym: Symbol, in_vars: tuple)
CPROC = "cproc"
# (CROUT, out_vars: tuple, sym: Symbol, in_vars: tuple) — binds the
# results of coroutine `sym` applied to the inputs (Op::Crout,
# reference src/lem/mod.rs:214); dispatched through a memoset Scope
CROUT = "crout"
# (CALL, out_vars: tuple, func: Func, in_vars: tuple)
CALL = "call"
# (COPY, tgt, src)
COPY = "copy"
# (ZERO, tgt, tag)
ZERO = "zero"
# (HASH3ZEROS | HASH4ZEROS | HASH6ZEROS | HASH8ZEROS, tgt, tag)
HASH3ZEROS = "hash3zeros"
HASH4ZEROS = "hash4zeros"
HASH6ZEROS = "hash6zeros"
HASH8ZEROS = "hash8zeros"
# (LIT, tgt, lit: Lit)
LITOP = "lit"
# (CAST, tgt, tag, src)
CAST = "cast"
# (EQTAG | EQVAL, tgt, a, b) -> bool var
EQTAG = "eq_tag"
EQVAL = "eq_val"
# (NOT, tgt, a); (AND | OR, tgt, a, b) -> bool vars
NOT = "not"
AND = "and"
OR = "or"
# (ADD | SUB | MUL | DIV, tgt, a, b)
ADD = "add"
SUB = "sub"
MUL = "mul"
DIV = "div"
# (LT, tgt, a, b) -> bool var
LT = "lt"
# (TRUNC, tgt, a, n)
TRUNC = "trunc"
# (DIVREM64, (tgt_div, tgt_rem), a, b)
DIVREM64 = "divrem64"
# (EMIT, a) / (RECV, a)
EMIT = "emit"
RECV = "recv"
# (CONS2 | CONS3 | CONS4, img, tag, preimg_vars: tuple)
CONS2 = "cons2"
CONS3 = "cons3"
CONS4 = "cons4"
# (DECONS2 | DECONS3 | DECONS4, preimg_vars: tuple, img)
DECONS2 = "decons2"
DECONS3 = "decons3"
DECONS4 = "decons4"
# (PUSHBINDING, img, (sym, val, env)) / (POPBINDING, (sym, val, env), img)
PUSHBINDING = "push_binding"
POPBINDING = "pop_binding"
# (HIDE, tgt, secret, payload) / (OPEN, tgt_secret, tgt_payload, comm)
HIDE = "hide"
OPEN = "open"

Op = tuple


# ---------------------------------------------------------------------------
# Control
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatchTag:
    var: str
    cases: Tuple[Tuple[int, "Block"], ...]
    default: Optional["Block"] = None


@dataclasses.dataclass(frozen=True)
class MatchValue:
    var: str
    lit_type: str       # LIT_NUM | LIT_STRING | LIT_SYMBOL
    cases: Tuple[Tuple[Lit, "Block"], ...]
    default: Optional["Block"] = None


@dataclasses.dataclass(frozen=True)
class If:
    var: str
    true_block: "Block"
    false_block: "Block"


@dataclasses.dataclass(frozen=True)
class Return:
    vars: Tuple[str, ...]


Ctrl = Union[MatchTag, MatchValue, If, Return]


@dataclasses.dataclass(frozen=True)
class Block:
    ops: Tuple[Op, ...]
    ctrl: Ctrl


@dataclasses.dataclass
class Func:
    """A LEM function: input params, output size and a body block.

    ``slots_count`` is filled by :func:`lurk_tpu_torch.lem.slots.count_slots` at
    construction time (Func::new parity, src/lem/mod.rs:298-320).
    """

    name: str
    input_params: Tuple[str, ...]
    output_size: int
    body: Block
    slots_count: "SlotsCounter" = None  # type: ignore[assignment]

    def __post_init__(self):
        from .slots import count_slots
        if self.slots_count is None:
            self.slots_count = count_slots(self.body)


# ---------------------------------------------------------------------------
# Construction helpers (the Python stand-in for the reference's LEM macros)
# ---------------------------------------------------------------------------


def block(*items) -> Block:
    """block(op, op, ..., ctrl) — last item must be a Ctrl node."""
    *ops, ctrl = items
    assert isinstance(ctrl, (MatchTag, MatchValue, If, Return)), ctrl
    return Block(tuple(ops), ctrl)


def ret(*vars_) -> Return:
    return Return(tuple(vars_))


def match_tag(var: str, cases: Sequence[Tuple[int, Block]],
              default: Optional[Block] = None) -> MatchTag:
    return MatchTag(var, tuple(cases), default)


def match_symbol(var: str, cases: Sequence[Tuple[Symbol, Block]],
                 default: Optional[Block] = None) -> MatchValue:
    lits = tuple((Lit.symbol(s), b) for s, b in cases)
    return MatchValue(var, LIT_SYMBOL, lits, default)


def if_(var: str, true_block: Block, false_block: Block) -> If:
    return If(var, true_block, false_block)


def if_not(var: str, true_block: Block, false_block: Block) -> If:
    """if !var { true_block } else { false_block }"""
    return If(var, false_block, true_block)


# ---------------------------------------------------------------------------
# Static checks + SSA deconflict pass (Func::new parity)
# ---------------------------------------------------------------------------


def op_def_use(op: Op) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(defined_vars, used_vars) of an op."""
    k = op[0]
    if k in (CPROC, CROUT):
        return tuple(op[1]), tuple(op[3])
    if k == CALL:
        return tuple(op[1]), tuple(op[3])
    if k == COPY:
        return (op[1],), (op[2],)
    if k in (ZERO, HASH3ZEROS, HASH4ZEROS, HASH6ZEROS, HASH8ZEROS, LITOP):
        return (op[1],), ()
    if k == CAST:
        return (op[1],), (op[3],)
    if k in (EQTAG, EQVAL, AND, OR, ADD, SUB, MUL, DIV, LT):
        return (op[1],), (op[2], op[3])
    if k == NOT:
        return (op[1],), (op[2],)
    if k == TRUNC:
        return (op[1],), (op[2],)
    if k == DIVREM64:
        return tuple(op[1]), (op[2], op[3])
    if k == EMIT:
        return (), (op[1],)
    if k == RECV:
        return (op[1],), ()
    if k in (CONS2, CONS3, CONS4):
        return (op[1],), tuple(op[3])
    if k in (DECONS2, DECONS3, DECONS4):
        return tuple(op[1]), (op[2],)
    if k == PUSHBINDING:
        return (op[1],), tuple(op[2])
    if k == POPBINDING:
        return tuple(op[1]), (op[2],)
    if k == HIDE:
        return (op[1],), (op[2], op[3])
    if k == OPEN:
        return (op[1], op[2]), (op[3],)
    raise ValueError(f"unknown op kind {k}")


def _rename_op(op: Op, env: Dict[str, str], uniq: List[int]) -> Op:
    def use(v: str) -> str:
        try:
            return env[v]
        except KeyError:
            raise NameError(f"variable {v} not bound") from None

    def bind(v: str) -> str:
        uniq[0] += 1
        nv = f"{v}#{uniq[0]}"
        env[v] = nv
        return nv

    k = op[0]
    if k in (CPROC, CROUT):
        ins = tuple(use(v) for v in op[3])
        outs = tuple(bind(v) for v in op[1])
        return (k, outs, op[2], ins)
    if k == CALL:
        ins = tuple(use(v) for v in op[3])
        func = deconflict_func(op[2])
        outs = tuple(bind(v) for v in op[1])
        return (k, outs, func, ins)
    if k == COPY:
        s = use(op[2])
        return (k, bind(op[1]), s)
    if k in (ZERO, HASH3ZEROS, HASH4ZEROS, HASH6ZEROS, HASH8ZEROS):
        return (k, bind(op[1]), op[2])
    if k == LITOP:
        return (k, bind(op[1]), op[2])
    if k == CAST:
        s = use(op[3])
        return (k, bind(op[1]), op[2], s)
    if k in (EQTAG, EQVAL, AND, OR, ADD, SUB, MUL, DIV, LT):
        a, b = use(op[2]), use(op[3])
        return (k, bind(op[1]), a, b)
    if k == NOT:
        a = use(op[2])
        return (k, bind(op[1]), a)
    if k == TRUNC:
        a = use(op[2])
        return (k, bind(op[1]), a, op[3])
    if k == DIVREM64:
        a, b = use(op[2]), use(op[3])
        return (k, tuple(bind(v) for v in op[1]), a, b)
    if k == EMIT:
        return (k, use(op[1]))
    if k == RECV:
        return (k, bind(op[1]))
    if k in (CONS2, CONS3, CONS4):
        pre = tuple(use(v) for v in op[3])
        return (k, bind(op[1]), op[2], pre)
    if k in (DECONS2, DECONS3, DECONS4):
        img = use(op[2])
        return (k, tuple(bind(v) for v in op[1]), img)
    if k == PUSHBINDING:
        pre = tuple(use(v) for v in op[2])
        return (k, bind(op[1]), pre)
    if k == POPBINDING:
        img = use(op[2])
        return (k, tuple(bind(v) for v in op[1]), img)
    if k == HIDE:
        a, b = use(op[2]), use(op[3])
        return (k, bind(op[1]), a, b)
    if k == OPEN:
        c = use(op[3])
        return (k, bind(op[1]), bind(op[2]), c)
    raise ValueError(f"unknown op kind {k}")


def _rename_block(b: Block, env: Dict[str, str], uniq: List[int]) -> Block:
    env = dict(env)  # blocks delimit scope
    ops = tuple(_rename_op(op, env, uniq) for op in b.ops)
    c = b.ctrl
    if isinstance(c, Return):
        ctrl: Ctrl = Return(tuple(env[v] for v in c.vars))
    elif isinstance(c, If):
        ctrl = If(env[c.var],
                  _rename_block(c.true_block, env, uniq),
                  _rename_block(c.false_block, env, uniq))
    elif isinstance(c, MatchTag):
        ctrl = MatchTag(
            env[c.var],
            tuple((t, _rename_block(blk, env, uniq)) for t, blk in c.cases),
            _rename_block(c.default, env, uniq) if c.default else None,
        )
    else:
        assert isinstance(c, MatchValue)
        ctrl = MatchValue(
            env[c.var], c.lit_type,
            tuple((lit, _rename_block(blk, env, uniq))
                  for lit, blk in c.cases),
            _rename_block(c.default, env, uniq) if c.default else None,
        )
    return Block(ops, ctrl)


def deconflict_func(func: Func) -> Func:
    """SSA renaming: every binding gets a fresh name (deconflict parity,
    src/lem/mod.rs:465-530). Callee funcs are deconflicted independently."""
    uniq = [0]
    env = {p: p for p in func.input_params}
    body = _rename_block(func.body, env, uniq)
    return Func(func.name, func.input_params, func.output_size, body,
                slots_count=func.slots_count)


def check_func(func: Func) -> None:
    """Static checks: all vars bound, return sizes match output_size."""

    def chk_block(b: Block, bound: set) -> None:
        bound = set(bound)
        for op in b.ops:
            defs, uses = op_def_use(op)
            for v in uses:
                if v not in bound:
                    raise NameError(
                        f"{func.name}: variable {v} used before bound")
            if op[0] == CALL:
                callee: Func = op[2]
                assert len(op[3]) == len(callee.input_params), \
                    f"{func.name}: call arity mismatch for {callee.name}"
                assert len(op[1]) == callee.output_size
            bound.update(defs)
        c = b.ctrl
        if isinstance(c, Return):
            if len(c.vars) != func.output_size:
                raise ValueError(
                    f"{func.name}: return size {len(c.vars)} != "
                    f"{func.output_size}")
            for v in c.vars:
                if v not in bound:
                    raise NameError(f"{func.name}: return of unbound {v}")
        elif isinstance(c, If):
            if c.var not in bound:
                raise NameError(f"{func.name}: if on unbound {c.var}")
            chk_block(c.true_block, bound)
            chk_block(c.false_block, bound)
        else:
            if c.var not in bound:
                raise NameError(f"{func.name}: match on unbound {c.var}")
            seen = set()
            for key, blk in c.cases:
                if isinstance(c, MatchTag):
                    k = key
                else:
                    k = (key.kind, key.value)
                if k in seen:
                    raise ValueError(f"{func.name}: duplicate match case {k}")
                seen.add(k)
                chk_block(blk, bound)
            if c.default is not None:
                chk_block(c.default, bound)

    chk_block(func.body, set(func.input_params))


def mk_func(name: str, input_params: Sequence[str], output_size: int,
            body: Block) -> Func:
    """Func::new parity: check + deconflict + slot count."""
    f = Func(name, tuple(input_params), output_size, body)
    check_func(f)
    return deconflict_func(f)
