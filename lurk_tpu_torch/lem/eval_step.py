"""Lurk's universal step function, authored in the LEM IR.

This is the CEK-machine reducer ``step = make_thunk . apply_cont . reduce``
with IVC/NIVC variants and coprocessor dispatch. Semantics parity:
reference src/lem/eval.rs:408-1938 (make_eval_step, reduce,
apply_cont, make_thunk, run_cproc, is_cproc, match_and_run_cproc) — the
structure below re-expresses the same LEM program with Python constructor
helpers instead of the Rust `func!`/`op!` macros.

Iteration counts and hash-slot usage of evaluation must match the
reference bit-for-bit; eval tests pin them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..symbol import Symbol, lurk_sym
from ..tags import ContTag as C
from ..tags import ExprTag as E
from ..tags import Op1, Op2
from . import ir
from .ir import Block, Lit, block, if_, if_not, match_tag, match_symbol, \
    mk_func, ret

# ---------------------------------------------------------------------------
# op constructor helpers (the `op!` macro equivalents)
# ---------------------------------------------------------------------------


def sym(v, name):
    return (ir.LITOP, v, Lit.symbol(lurk_sym(name)))


def lit_num(v, n):
    return (ir.LITOP, v, Lit.num(n))


def lit_str(v, s):
    return (ir.LITOP, v, Lit.string(s))


def zero(v, tag):
    return (ir.ZERO, v, int(tag))


def h8z(v, tag):
    return (ir.HASH8ZEROS, v, int(tag))


def copy(v, s):
    return (ir.COPY, v, s)


def cast(v, tag, src):
    return (ir.CAST, v, int(tag), src)


def eq_tag(v, a, b):
    return (ir.EQTAG, v, a, b)


def eq_val(v, a, b):
    return (ir.EQVAL, v, a, b)


def not_(v, a):
    return (ir.NOT, v, a)


def and_(v, a, b):
    return (ir.AND, v, a, b)


def or_(v, a, b):
    return (ir.OR, v, a, b)


def add(v, a, b):
    return (ir.ADD, v, a, b)


def sub(v, a, b):
    return (ir.SUB, v, a, b)


def mul(v, a, b):
    return (ir.MUL, v, a, b)


def div(v, a, b):
    return (ir.DIV, v, a, b)


def lt(v, a, b):
    return (ir.LT, v, a, b)


def trunc(v, a, n):
    return (ir.TRUNC, v, a, n)


def div_rem64(vd, vr, a, b):
    return (ir.DIVREM64, (vd, vr), a, b)


def emit(a):
    return (ir.EMIT, a)


def recv(v):
    return (ir.RECV, v)


def cons2(v, tag, a, b):
    return (ir.CONS2, v, int(tag), (a, b))


def cons4(v, tag, a, b, c, d):
    return (ir.CONS4, v, int(tag), (a, b, c, d))


def decons2(a, b, img):
    return (ir.DECONS2, (a, b), img)


def decons4(a, b, c, d, img):
    return (ir.DECONS4, (a, b, c, d), img)


def push_binding(v, s, val, e):
    return (ir.PUSHBINDING, v, (s, val, e))


def pop_binding(s, val, e, img):
    return (ir.POPBINDING, (s, val, e), img)


def hide(v, s, p):
    return (ir.HIDE, v, s, p)


def open_(s, p, c):
    return (ir.OPEN, s, p, c)


def call(outs, func, ins):
    return (ir.CALL, tuple(outs), func, tuple(ins))


def cproc_op(outs, sym_, ins):
    return (ir.CPROC, tuple(outs), sym_, tuple(ins))


# ---------------------------------------------------------------------------
# auxiliary Funcs (eval.rs:434-795)
# ---------------------------------------------------------------------------


def car_cdr_simple() -> ir.Func:
    """eval.rs:436-450: car/cdr without string deconstruction."""
    return mk_func("car_cdr_simple", ["xs"], 2, block(
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        match_tag("xs", [
            (E.Nil, block(ret("nil", "nil"))),
            (E.Cons, block(
                decons2("car", "cdr", "xs"),
                ret("car", "cdr"))),
        ]),
    ))


def _expand_bindings() -> ir.Func:
    return mk_func("expand_bindings",
                   ["head", "body", "body1", "rest_bindings"], 1, block(
        match_tag("rest_bindings", [
            (E.Nil, block(ret("body1"))),
        ], block(
            cons2("expanded_0", E.Cons, "rest_bindings", "body"),
            cons2("expanded", E.Cons, "head", "expanded_0"),
            ret("expanded"))),
    ))


_UNOPS = [
    ("car", Op1.Car), ("cdr", Op1.Cdr), ("commit", Op1.Commit),
    ("num", Op1.Num), ("u64", Op1.U64), ("comm", Op1.Comm),
    ("char", Op1.Char), ("open", Op1.Open), ("secret", Op1.Secret),
    ("atom", Op1.Atom), ("emit", Op1.Emit),
]

_BINOPS = [
    ("cons", Op2.Cons), ("strcons", Op2.StrCons), ("hide", Op2.Hide),
    ("+", Op2.Sum), ("-", Op2.Diff), ("*", Op2.Product),
    ("/", Op2.Quotient), ("%", Op2.Modulo), ("=", Op2.NumEqual),
    ("eq", Op2.Equal), ("<", Op2.Less), (">", Op2.Greater),
    ("<=", Op2.LessEqual), (">=", Op2.GreaterEqual),
]


def _get_op_func(name: str, table) -> ir.Func:
    cases = [
        (lurk_sym(s), block(zero("op", tag), ret("op")))
        for s, tag in table
    ]
    return mk_func(name, ["head"], 1, block(
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        match_symbol("head", cases, block(ret("nil"))),
    ))


def _is_potentially_fun() -> ir.Func:
    return mk_func("is_potentially_fun", ["head"], 1, block(
        zero("fun", E.Fun),
        zero("cons", E.Cons),
        zero("thunk", E.Thunk),
        zero("num", E.Num),
        zero("comm", E.Comm),
        eq_tag("head_is_fun", "head", "fun"),
        eq_tag("head_is_cons", "head", "cons"),
        eq_tag("head_is_thunk", "head", "thunk"),
        eq_tag("head_is_num", "head", "num"),
        eq_tag("head_is_comm", "head", "comm"),
        or_("acc", "head_is_fun", "head_is_cons"),
        or_("acc", "acc", "head_is_thunk"),
        or_("acc", "acc", "head_is_num"),
        or_("acc", "acc", "head_is_comm"),
        if_("acc",
            block(sym("t", "t"), ret("t")),
            block(sym("nil", "nil"), cast("nil", E.Nil, "nil"),
                  ret("nil"))),
    ))


def _is_cproc(cprocs: Sequence[Tuple[Symbol, int]]) -> ir.Func:
    """eval.rs:600-633."""
    if not cprocs:
        return mk_func("is_cproc", ["_head"], 1, block(
            sym("nil", "nil"),
            cast("nil", E.Nil, "nil"),
            ret("nil"),
        ))
    cases = [(s, block(ret("t"))) for s, _ in cprocs]
    return mk_func("is_cproc", ["head"], 1, block(
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        sym("t", "t"),
        match_symbol("head", cases, block(ret("nil"))),
    ))


def _lookup() -> ir.Func:
    return mk_func("lookup", ["expr", "env", "state"], 3, block(
        sym("found", "found"),
        sym("not_found", "not_found"),
        sym("error", "error"),
        eq_val("continue", "not_found", "state"),
        if_not("continue", block(ret("expr", "env", "state")), block(
            lit_num("zero", 0),
            eq_val("env_is_zero", "env", "zero"),
            if_("env_is_zero",
                block(ret("expr", "env", "error")),
                block(
                    pop_binding("var", "val", "smaller_env", "env"),
                    eq_val("is_eq", "var", "expr"),
                    if_("is_eq",
                        block(ret("val", "env", "found")),
                        block(ret("expr", "smaller_env",
                                  "not_found"))))))),
    ))


def _mk_stream_call_cont() -> ir.Func:
    return mk_func("mk_stream_call_cont", ["env"], 1, block(
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        zero("foo", E.Nil),
        recv("arg"),
        cons2("arg_list", E.Cons, "arg", "nil"),
        h8z("cont", C.StreamDispatch),
        cons4("cont", C.Call, "arg_list", "env", "cont", "foo"),
        ret("cont"),
    ))


# ---------------------------------------------------------------------------
# coprocessor call plumbing (eval.rs:505-597, 636-795, 1317-1345)
# ---------------------------------------------------------------------------


def _destructure_args_block(cproc_sym: Symbol, arity: int,
                            inner: Block, err_block: Block) -> Block:
    """Shared arg-destructuring spine of run_cproc / match_and_run_cproc:
    peel `arity` args off `evaluated_args` via car_cdr_simple, erroring on
    arity mismatch (eval.rs:521-556 pseudo-code)."""
    ccs = car_cdr_simple()
    blk = inner
    arg_names = [f"x{i}" for i in range(arity)]
    for i, arg in enumerate(arg_names):
        ops = [
            call([arg, "evaluated_args"], ccs, ["evaluated_args"]),
            eq_tag("is_nil", "evaluated_args", "nil"),
        ]
        if i == 0:
            ctrl = if_("is_nil", blk, err_block)
        else:
            ctrl = if_("is_nil", err_block, blk)
        blk = Block(tuple(ops), ctrl)
    if arity > 0:
        blk = Block((
            eq_tag("is_nil", "evaluated_args", "nil"),
            copy("evaluated_args_cp", "evaluated_args"),
        ), if_("is_nil", err_block, blk))
    return blk


def run_cproc(cproc_sym: Symbol, arity: int) -> ir.Func:
    """NIVC standalone coprocessor Func (eval.rs:505-585)."""
    arg_names = [f"x{i}" for i in range(arity)]
    cproc_inp = arg_names + ["env", "cont"]
    inner = Block((
        cproc_op(["expr", "env", "cont"], cproc_sym, cproc_inp),
        cons2("expr", E.Thunk, "expr", "cont"),
    ), ir.Return(("expr", "env", "cont")))
    err_block = Block((), ir.Return(("evaluated_args_cp", "env", "err")))
    blk = _destructure_args_block(cproc_sym, arity, inner, err_block)
    blk = Block(
        (decons2("cproc_name", "evaluated_args", "cproc"),),
        ir.MatchValue("cproc_name", ir.LIT_SYMBOL,
                      ((Lit.symbol(cproc_sym), blk),), None))
    ops = () if arity == 0 else (
        h8z("err", C.Error),
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
    )
    body = Block(ops, ir.MatchTag("cproc", ((int(E.Cproc), blk),), None))
    return mk_func("run_cproc", ["cproc", "env", "cont"], 3, body)


def make_cprocs_funcs(cprocs: Sequence[Tuple[Symbol, int]]) -> List[ir.Func]:
    """make_cprocs_funcs_from_lang parity (eval.rs:589-597)."""
    return [run_cproc(s, a) for s, a in cprocs]


def _match_and_run_cproc(cprocs: Sequence[Tuple[Symbol, int]]) -> ir.Func:
    """IVC in-circuit coprocessor dispatch (eval.rs:700-795)."""
    max_arity = max((a for _, a in cprocs), default=0)
    err_block = Block((), ir.Return(
        ("evaluated_args_cp", "env", "err", "errctrl")))
    check_cproc_error = ir.MatchTag("cont", (
        (int(C.Error),
         Block((), ir.Return(("expr", "env", "err", "errctrl")))),
        (int(C.Terminal),
         Block((), ir.Return(("expr", "env", "cont", "ret")))),
    ), Block((), ir.Return(("expr", "env", "cont", "makethunk"))))
    cases = []
    for s, arity in cprocs:
        cproc_inp = [f"x{i}" for i in range(arity)] + ["env", "cont"]
        inner = Block(
            (cproc_op(["expr", "env", "cont"], s, cproc_inp),),
            check_cproc_error)
        cases.append((Lit.symbol(s),
                      _destructure_args_block(s, arity, inner, err_block)))
    ops = [
        h8z("err", C.Error),
        sym("makethunk", "make-thunk"),
        sym("errctrl", "error"),
        sym("ret", "return"),
    ]
    if max_arity > 0:
        ops += [sym("nil", "nil"), cast("nil", E.Nil, "nil")]
    body = Block(tuple(ops), ir.MatchValue(
        "cproc_name", ir.LIT_SYMBOL, tuple(cases), None))
    return mk_func(
        "match_and_run_cproc",
        ["cproc_name", "evaluated_args", "env", "cont"], 4, body)


def _choose_cproc_call(cprocs: Sequence[Tuple[Symbol, int]],
                       ivc: bool) -> ir.Func:
    """eval.rs:1317-1345."""
    if not cprocs:
        return mk_func(
            "no_cproc_error",
            ["cproc_name", "_evaluated_args", "env", "_cont"], 4, block(
                h8z("err", C.Error),
                sym("errctrl", "error"),
                ret("cproc_name", "env", "err", "errctrl"),
            ))
    if ivc:
        return _match_and_run_cproc(cprocs)
    return mk_func(
        "setup_cproc_loop",
        ["cproc_name", "evaluated_args", "env", "cont"], 4, block(
            sym("ret", "return"),
            cons2("cproc", E.Cproc, "cproc_name", "evaluated_args"),
            ret("cproc", "env", "cont", "ret"),
        ))


# ---------------------------------------------------------------------------
# reduce (eval.rs:797-1315)
# ---------------------------------------------------------------------------


def _reduce(cprocs: Sequence[Tuple[Symbol, int]]) -> ir.Func:
    ccs = car_cdr_simple()
    expand_bindings = _expand_bindings()
    get_unop = _get_op_func("get_unop", _UNOPS)
    get_binop = _get_op_func("get_binop", _BINOPS)
    is_potentially_fun = _is_potentially_fun()
    is_cproc = _is_cproc(cprocs)
    lookup = _lookup()
    mk_stream_call_cont = _mk_stream_call_cont()

    err4 = block(ret("expr", "env", "err", "errctrl"))

    # --- let / letrec (shared head via head_is_let_sym flag) ---
    let_block = block(
        call(["bindings", "body"], ccs, ["rest"]),
        call(["body1", "rest_body"], ccs, ["body"]),
        # Only a single body form allowed for now.
        match_tag("body", [
            (E.Nil, err4),
        ], block(match_tag("rest_body", [
            (E.Nil, block(match_tag("bindings", [
                (E.Nil, block(ret("body1", "env", "cont", "ret"))),
            ], block(
                call(["binding1", "rest_bindings"], ccs, ["bindings"]),
                call(["var", "vals"], ccs, ["binding1"]),
                match_tag("var", [
                    (E.Sym, block(
                        call(["val", "end"], ccs, ["vals"]),
                        eq_tag("end_is_nil", "end", "nil"),
                        if_not("end_is_nil", err4, block(
                            call(["expanded"], expand_bindings,
                                 ["head", "body", "body1",
                                  "rest_bindings"]),
                            if_("head_is_let_sym",
                                block(
                                    cons4("cont", C.Let, "var", "env",
                                          "expanded", "cont"),
                                    ret("val", "env", "cont", "ret")),
                                block(
                                    cons4("cont", C.LetRec, "var", "env",
                                          "expanded", "cont"),
                                    ret("val", "env", "cont",
                                        "ret"))))))),
                ], err4))))),
        ], err4))),
    )

    lambda_block = block(
        call(["vars", "rest"], ccs, ["rest"]),
        eq_tag("rest_nil", "rest", "nil"),
        if_("rest_nil", err4, block(
            call(["body", "end"], ccs, ["rest"]),
            eq_tag("end_nil", "end", "nil"),
            if_not("end_nil", err4, block(
                match_tag("vars", [
                    (E.Cons, block(
                        decons2("var", "_rest_vars", "vars"),
                        match_tag("var", [
                            (E.Sym, block(
                                cons4("fun", E.Fun, "vars", "body", "env",
                                      "foo"),
                                ret("fun", "env", "cont", "apply"))),
                        ], err4))),
                    (E.Nil, block(
                        cons4("fun", E.Fun, "vars", "body", "env", "foo"),
                        ret("fun", "env", "cont", "apply"))),
                ], err4))))),
    )

    quote_block = block(
        call(["quoted", "end"], ccs, ["rest"]),
        match_tag("end", [
            (E.Nil, block(ret("quoted", "env", "cont", "apply"))),
        ], err4),
    )

    begin_block = block(
        call(["arg1", "more"], ccs, ["rest"]),
        match_tag("more", [
            (E.Nil, block(ret("arg1", "env", "cont", "ret"))),
        ], block(
            zero("op", Op2.Begin),
            cons4("cont", C.Binop, "op", "env", "more", "cont"),
            ret("arg1", "env", "cont", "ret"))),
    )

    eval_block = block(
        match_tag("rest", [
            (E.Nil, err4),
        ], block(
            call(["arg1", "more"], ccs, ["rest"]),
            match_tag("more", [
                (E.Nil, block(
                    zero("op", Op1.Eval),
                    cons4("cont", C.Unop, "op", "cont", "foo", "foo"),
                    ret("arg1", "env", "cont", "ret"))),
            ], block(
                zero("op", Op2.Eval),
                cons4("cont", C.Binop, "op", "env", "more", "cont"),
                ret("arg1", "env", "cont", "ret"))))),
    )

    if_block = block(
        call(["condition", "more"], ccs, ["rest"]),
        match_tag("more", [
            (E.Nil, err4),
        ], block(
            cons4("cont", C.If, "more", "env", "cont", "foo"),
            ret("condition", "env", "cont", "ret"))),
    )

    empty_env_block = block(match_tag("rest", [
        (E.Nil, block(
            zero("empty_env", E.Env),
            ret("empty_env", "env", "cont", "apply"))),
    ], err4))

    current_env_block = block(match_tag("rest", [
        (E.Nil, block(ret("env", "env", "cont", "apply"))),
    ], err4))

    # after the special-form match: unops -> binops -> cprocs -> call
    unop_dispatch = block(
        if_not("rest_is_nil", block(
            decons2("arg1", "end", "rest"),
            eq_tag("end_is_nil", "end", "nil"),
            if_("end_is_nil", block(
                cons4("cont", C.Unop, "op", "cont", "foo", "foo"),
                ret("arg1", "env", "cont", "ret")),
                err4)),
            err4),
    )
    binop_dispatch = block(
        if_not("rest_is_nil", block(
            decons2("arg1", "more", "rest"),
            eq_tag("more_is_nil", "more", "nil"),
            if_not("more_is_nil", block(
                cons4("cont", C.Binop, "op", "env", "more", "cont"),
                ret("arg1", "env", "cont", "ret")),
                err4)),
            err4),
    )
    cproc_dispatch = block(
        if_("rest_is_nil", block(
            cons2("args", E.Cons, "nil", "nil"),
            cons4("cont", C.Cproc, "head", "args", "env", "cont"),
            ret("nil", "env", "cont", "apply")),
            block(
                call(["arg", "unevaled_args"], ccs, ["rest"]),
                cons2("args", E.Cons, "unevaled_args", "nil"),
                cons4("cont", C.Cproc, "head", "args", "env", "cont"),
                ret("arg", "env", "cont", "ret"))),
    )
    # just call assuming the symbol is bound to a function
    plain_call = block(
        cons4("cont", C.Call, "rest", "env", "cont", "foo"),
        ret("head", "env", "cont", "ret"),
    )
    cproc_or_call = block(
        call(["is_cproc"], is_cproc, ["head"]),
        eq_val("is_cproc_is_t", "is_cproc", "t"),
        if_("is_cproc_is_t", cproc_dispatch, plain_call),
    )
    tail_block = block(
        call(["op"], get_unop, ["head"]),
        eq_tag("op_is_nil", "op", "nil"),
        if_not("op_is_nil", unop_dispatch, block(
            call(["op"], get_binop, ["head"]),
            eq_tag("op_is_nil", "op", "nil"),
            if_not("op_is_nil", binop_dispatch, cproc_or_call))),
    )

    sym_head_block = block(
        sym("let_sym", "let"),
        sym("letrec_sym", "letrec"),
        eq_val("head_is_let_sym", "head", "let_sym"),
        eq_val("head_is_letrec_sym", "head", "letrec_sym"),
        or_("head_is_let_or_letrec_sym", "head_is_let_sym",
            "head_is_letrec_sym"),
        if_("head_is_let_or_letrec_sym", let_block, block(
            match_symbol("head", [
                (lurk_sym("lambda"), lambda_block),
                (lurk_sym("quote"), quote_block),
                (lurk_sym("begin"), begin_block),
                (lurk_sym("eval"), eval_block),
                (lurk_sym("if"), if_block),
                (lurk_sym("empty-env"), empty_env_block),
                (lurk_sym("current-env"), current_env_block),
            ], tail_block))),
    )

    cons_block = block(
        # No need for car_cdr_simple: the expression is already a Cons
        decons2("head", "rest", "expr"),
        eq_tag("rest_is_nil", "rest", "nil"),
        eq_tag("rest_is_cons", "rest", "expr"),
        or_("rest_is_nil_or_cons", "rest_is_nil", "rest_is_cons"),
        if_not("rest_is_nil_or_cons", err4, block(
            match_tag("head", [
                (E.Sym, sym_head_block),
            ], block(
                call(["potentially_fun"], is_potentially_fun, ["head"]),
                eq_val("is_eq", "potentially_fun", "t"),
                if_("is_eq", block(
                    cons4("cont", C.Call, "rest", "env", "cont", "foo"),
                    ret("head", "env", "cont", "ret")),
                    err4))))),
    )

    sym_block = block(
        eq_val("expr_is_nil", "expr", "nil"),
        eq_val("expr_is_t", "expr", "t"),
        or_("expr_is_nil_or_t", "expr_is_nil", "expr_is_t"),
        if_("expr_is_nil_or_t",
            block(ret("expr", "env", "cont", "apply")),
            block(
                sym("not_found", "not_found"),
                call(["res", "res_env", "state"], lookup,
                     ["expr", "env", "not_found"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                call(["res", "res_env", "state"], lookup,
                     ["res", "res_env", "state"]),
                match_symbol("state", [
                    (lurk_sym("error"), err4),
                    (lurk_sym("found"), block(match_tag("res", [
                        (E.Rec, block(
                            decons4("args", "body", "closed_env", "_foo",
                                    "res"),
                            push_binding("extended", "expr", "res",
                                         "closed_env"),
                            cons4("fun", E.Fun, "args", "body", "extended",
                                  "foo"),
                            ret("fun", "res_env", "cont", "apply"))),
                    ], block(ret("res", "res_env", "cont", "apply"))))),
                    (lurk_sym("not_found"),
                     block(ret("res", "res_env", "cont", "ret"))),
                ]))),
    )

    body = block(
        sym("ret", "return"),
        h8z("term", C.Terminal),
        h8z("err", C.Error),
        zero("cproc", E.Cproc),
        # stuttering condition when not in StreamPause
        eq_tag("cont_is_term", "cont", "term"),
        eq_tag("cont_is_err", "cont", "err"),
        eq_tag("expr_is_cproc", "expr", "cproc"),
        or_("acc_ret", "cont_is_term", "cont_is_err"),
        or_("acc_ret", "acc_ret", "expr_is_cproc"),
        if_("acc_ret", block(ret("expr", "env", "cont", "ret")), block(
            sym("errctrl", "error"),
            match_tag("cont", [
                (C.StreamStart, block(
                    call(["cont"], mk_stream_call_cont, ["env"]),
                    ret("expr", "env", "cont", "ret"))),
                (C.StreamPause, block(
                    recv("stutter"),
                    match_tag("stutter", [
                        (E.Nil, block(match_tag("expr", [
                            (E.Cons, block(
                                decons2("_result", "callable", "expr"),
                                call(["cont"], mk_stream_call_cont,
                                     ["env"]),
                                ret("callable", "env", "cont", "ret"))),
                        ], err4))),
                    ], block(ret("expr", "env", "cont", "ret"))))),
            ], block(
                sym("apply", "apply-continuation"),
                zero("thunk", E.Thunk),
                zero("sym", E.Sym),
                zero("cons", E.Cons),
                eq_tag("expr_is_thunk", "expr", "thunk"),
                eq_tag("expr_is_sym", "expr", "sym"),
                eq_tag("expr_is_cons", "expr", "cons"),
                or_("acc_not_apply", "expr_is_thunk", "expr_is_sym"),
                or_("acc_not_apply", "acc_not_apply", "expr_is_cons"),
                if_not("acc_not_apply",
                       block(ret("expr", "env", "cont", "apply")),
                       block(
                           sym("nil", "nil"),
                           cast("nil", E.Nil, "nil"),
                           zero("foo", E.Nil),
                           sym("t", "t"),
                           match_tag("expr", [
                               (E.Thunk, block(
                                   decons2("thunk_expr",
                                           "thunk_continuation", "expr"),
                                   ret("thunk_expr", "env",
                                       "thunk_continuation", "apply"))),
                               (E.Sym, sym_block),
                               (E.Cons, cons_block),
                           ]))))))),
    )
    return mk_func("reduce", ["expr", "env", "cont"], 4, body)


# ---------------------------------------------------------------------------
# apply_cont (eval.rs:1347-1913)
# ---------------------------------------------------------------------------


def _args_num_type() -> ir.Func:
    num_ret = block(zero("ret_", E.Num), ret("ret_"))
    u64_ret = block(zero("ret_", E.U64), ret("ret_"))
    nil_ret = block(ret("nil"))
    return mk_func("args_num_type", ["arg1", "arg2"], 1, block(
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        match_tag("arg1", [
            (E.Num, block(match_tag("arg2", [
                (E.Num, num_ret),
                (E.U64, num_ret),
            ], nil_ret))),
            (E.U64, block(match_tag("arg2", [
                (E.Num, num_ret),
                (E.U64, u64_ret),
            ], nil_ret))),
        ], nil_ret),
    ))


def _open_if_num_or_comm() -> ir.Func:
    return mk_func("open_if_num_or_comm", ["input"], 1, block(
        zero("num", E.Num),
        zero("comm", E.Comm),
        eq_tag("input_is_num", "input", "num"),
        eq_tag("input_is_comm", "input", "comm"),
        or_("input_is_num_or_comm", "input_is_num", "input_is_comm"),
        if_("input_is_num_or_comm", block(
            cast("cast_", E.Comm, "input"),
            open_("_secret", "payload", "cast_"),
            ret("payload")),
            block(ret("input"))),
    ))


def _apply_cont(cprocs: Sequence[Tuple[Symbol, int]], ivc: bool) -> ir.Func:
    ccs = car_cdr_simple()
    args_num_type = _args_num_type()
    open_if_num_or_comm = _open_if_num_or_comm()
    choose_cproc_call = _choose_cproc_call(cprocs, ivc)

    err4 = block(ret("result", "env", "err", "errctrl"))
    mk = lambda *vars_: block(ret(*vars_))  # noqa: E731

    outermost_block = block(
        h8z("term", C.Terminal),
        # erase the environment to avoid leaking internal variables
        ret("result", "empty_env", "term", "ret"),
    )

    stream_dispatch_block = block(match_tag("result", [
        (E.Cons, block(
            h8z("pause", C.StreamPause),
            ret("result", "empty_env", "pause", "ret"))),
    ], err4))

    emit_block = block(
        decons4("cont", "_rest", "_foo1", "_foo2", "cont"),
        ret("result", "env", "cont", "makethunk"),
    )

    call_block = block(
        call(["fun"], open_if_num_or_comm, ["result"]),
        match_tag("fun", [
            (E.Fun, block(
                decons4("args", "args_env", "continuation", "_foo", "cont"),
                decons4("vars", "body", "fun_env", "_foo2", "fun"),
                match_tag("args", [
                    (E.Cons, block(match_tag("vars", [
                        (E.Nil,
                         # cannot apply arguments to a 0-arg function
                         block(ret("fun", "env", "err", "errctrl"))),
                        (E.Cons, block(
                            decons2("arg", "rest_args", "args"),
                            cons4("newer_cont", C.Call2, "fun",
                                  "rest_args", "args_env", "continuation"),
                            ret("arg", "args_env", "newer_cont", "ret"))),
                    ]))),
                    (E.Nil, block(match_tag("vars", [
                        (E.Nil, block(
                            ret("body", "fun_env", "continuation", "ret"))),
                        (E.Cons, block(
                            ret("fun", "env", "continuation", "ret"))),
                    ]))),
                ]))),
        ], block(ret("fun", "env", "err", "errctrl"))),
    )

    call2_block = block(
        decons4("function", "args", "args_env", "continuation", "cont"),
        match_tag("function", [
            (E.Fun, block(
                decons4("vars", "body", "fun_env", "_foo", "function"),
                # vars must be non-empty here
                decons2("var", "rest_vars", "vars"),
                push_binding("ext_env", "var", "result", "fun_env"),
                eq_tag("rest_vars_empty", "rest_vars", "nil"),
                eq_tag("args_empty", "args", "nil"),
                if_("rest_vars_empty", block(
                    if_("args_empty",
                        block(ret("body", "ext_env", "continuation",
                                  "ret")),
                        block(
                            # oversaturated call
                            cons4("cont", C.Call, "args", "args_env",
                                  "continuation", "foo"),
                            ret("body", "ext_env", "cont", "ret")))),
                    block(
                        cons4("ext_function", E.Fun, "rest_vars", "body",
                              "ext_env", "foo"),
                        call(["var", "_rest_vars"], ccs, ["rest_vars"]),
                        match_tag("var", [
                            (E.Sym, block(
                                if_("args_empty",
                                    # undersaturated call
                                    block(ret("ext_function", "ext_env",
                                              "continuation", "ret")),
                                    block(
                                        decons2("arg", "rest_args",
                                                "args"),
                                        cons4("cont", C.Call2,
                                              "ext_function", "rest_args",
                                              "args_env", "continuation"),
                                        ret("arg", "args_env", "cont",
                                            "ret"))))),
                        ], err4))))),
        ], err4),
    )

    let_block = block(
        decons4("var", "saved_env", "body", "cont", "cont"),
        push_binding("extended_env", "var", "result", "saved_env"),
        ret("body", "extended_env", "cont", "ret"),
    )

    letrec_block = block(
        decons4("var", "saved_env", "body", "cont", "cont"),
        match_tag("result", [
            (E.Fun, block(
                cast("result", E.Rec, "result"),
                push_binding("extended_env", "var", "result", "saved_env"),
                ret("body", "extended_env", "cont", "ret"))),
        ], block(
            push_binding("extended_env", "var", "result", "saved_env"),
            ret("body", "extended_env", "cont", "ret"))),
    )

    # ---- unop continuation ----
    car_cdr_cases = {}
    for which in ("car", "cdr"):
        str_blk = block(
            eq_val("is_empty", "result", "empty_str"),
            if_("is_empty",
                block(ret("nil" if which == "car" else "empty_str", "env",
                          "continuation", "makethunk")),
                block(
                    decons2("car", "cdr", "result"),
                    ret(which, "env", "continuation", "makethunk"))),
        )
        car_cdr_cases[which] = block(match_tag("result", [
            (E.Nil, block(ret("nil", "env", "continuation", "makethunk"))),
            (E.Cons, block(
                decons2("car", "cdr", "result"),
                ret(which, "env", "continuation", "makethunk"))),
            (E.Str, str_blk),
        ], err4))

    unop_block = block(
        zero("comm", E.Comm),
        eq_tag("result_is_char", "result", "char"),
        eq_tag("result_is_u64", "result", "u64"),
        eq_tag("result_is_num", "result", "zero"),
        eq_tag("result_is_comm", "result", "comm"),
        or_("result_is_num_or_comm", "result_is_num", "result_is_comm"),
        decons4("operator", "continuation", "_foo1", "_foo2", "cont"),
        match_tag("operator", [
            (Op1.Car, car_cdr_cases["car"]),
            (Op1.Cdr, car_cdr_cases["cdr"]),
            (Op1.Atom, block(match_tag("result", [
                (E.Cons,
                 block(ret("nil", "env", "continuation", "makethunk"))),
            ], block(ret("t", "env", "continuation", "makethunk"))))),
            (Op1.Emit, block(
                emit("result"),
                cons4("emit_cont", C.Emit, "continuation", "nil", "foo",
                      "foo"),
                ret("result", "env", "emit_cont", "makethunk"))),
            (Op1.Open, block(
                if_("result_is_num_or_comm", block(
                    cast("result", E.Comm, "result"),
                    open_("_secret", "payload", "result"),
                    ret("payload", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.Secret, block(
                if_("result_is_num_or_comm", block(
                    cast("result", E.Comm, "result"),
                    open_("secret", "_payload", "result"),
                    ret("secret", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.Commit, block(
                hide("comm_", "zero", "result"),
                ret("comm_", "env", "continuation", "makethunk"))),
            (Op1.Num, block(
                or_("acc_cast", "result_is_num_or_comm", "result_is_char"),
                or_("acc_cast", "acc_cast", "result_is_u64"),
                if_("acc_cast", block(
                    cast("cast_", E.Num, "result"),
                    ret("cast_", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.U64, block(
                or_("result_is_num_or_u64", "result_is_num",
                    "result_is_u64"),
                if_("result_is_num_or_u64", block(
                    trunc("trunc_", "result", 64),
                    cast("cast_", E.U64, "trunc_"),
                    ret("cast_", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.Comm, block(
                if_("result_is_num_or_comm", block(
                    cast("cast_", E.Comm, "result"),
                    ret("cast_", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.Char, block(
                or_("result_is_num_or_char", "result_is_num",
                    "result_is_char"),
                if_("result_is_num_or_char", block(
                    trunc("trunc_", "result", 32),
                    cast("cast_", E.Char, "trunc_"),
                    ret("cast_", "env", "continuation", "makethunk")),
                    err4))),
            (Op1.Eval, block(
                ret("result", "empty_env", "continuation", "ret"))),
        ], err4),
    )

    binop_block = block(
        decons4("operator", "saved_env", "unevaled_args", "continuation",
                "cont"),
        call(["arg2", "rest"], ccs, ["unevaled_args"]),
        match_tag("operator", [
            (Op2.Begin, block(match_tag("rest", [
                (E.Nil,
                 block(ret("arg2", "saved_env", "continuation", "ret"))),
            ], block(
                sym("begin", "begin"),
                cons2("begin_again", E.Cons, "begin", "unevaled_args"),
                ret("begin_again", "saved_env", "continuation",
                    "ctrl"))))),
        ], block(match_tag("rest", [
            (E.Nil, block(
                cons4("cont", C.Binop2, "operator", "result",
                      "continuation", "foo"),
                ret("arg2", "saved_env", "cont", "ret"))),
        ], err4))),
    )

    def _num_u64_dispatch(num_blk: Block, u64_blk: Block) -> Block:
        return block(match_tag("args_num_type", [
            (E.Nil, err4),
            (E.Num, num_blk),
            (E.U64, u64_blk),
        ]))

    binop2_block = block(
        lit_num("size_u64", 1 << 64),
        decons4("operator", "evaled_arg", "continuation", "_foo", "cont"),
        call(["args_num_type"], args_num_type, ["evaled_arg", "result"]),
        eq_tag("args_num_type_eq_nil", "args_num_type", "nil"),
        match_tag("operator", [
            (Op2.Eval, block(match_tag("result", [
                (E.Env,
                 block(ret("evaled_arg", "result", "continuation", "ret"))),
            ], err4))),
            (Op2.Cons, block(
                cons2("val", E.Cons, "evaled_arg", "result"),
                ret("val", "env", "continuation", "makethunk"))),
            (Op2.StrCons, block(
                eq_tag("result_is_str", "result", "empty_str"),
                eq_tag("evaled_arg_is_char", "evaled_arg", "char"),
                and_("acc_ok", "result_is_str", "evaled_arg_is_char"),
                if_("acc_ok", block(
                    cons2("val", E.Str, "evaled_arg", "result"),
                    ret("val", "env", "continuation", "makethunk")),
                    err4))),
            (Op2.Hide, block(match_tag("evaled_arg", [
                (E.Num, block(
                    hide("hidden", "evaled_arg", "result"),
                    ret("hidden", "env", "continuation", "makethunk"))),
            ], err4))),
            (Op2.Equal, block(
                eq_tag("eqt", "evaled_arg", "result"),
                eq_val("eqv", "evaled_arg", "result"),
                and_("eq", "eqt", "eqv"),
                if_("eq",
                    block(ret("t", "env", "continuation", "makethunk")),
                    block(ret("nil", "env", "continuation",
                              "makethunk"))))),
            (Op2.Sum, _num_u64_dispatch(
                block(
                    add("val", "evaled_arg", "result"),
                    ret("val", "env", "continuation", "makethunk")),
                block(
                    add("val", "evaled_arg", "result"),
                    lt("not_overflow", "val", "size_u64"),
                    if_("not_overflow", block(
                        cast("val", E.U64, "val"),
                        ret("val", "env", "continuation", "makethunk")),
                        block(
                            sub("val", "val", "size_u64"),
                            cast("val", E.U64, "val"),
                            ret("val", "env", "continuation",
                                "makethunk")))))),
            (Op2.Diff, _num_u64_dispatch(
                block(
                    sub("val", "evaled_arg", "result"),
                    ret("val", "env", "continuation", "makethunk")),
                block(
                    sub("val", "evaled_arg", "result"),
                    lt("is_neg", "val", "zero"),
                    not_("not_neg", "is_neg"),
                    if_("not_neg", block(
                        cast("val", E.U64, "val"),
                        ret("val", "env", "continuation", "makethunk")),
                        block(
                            add("val", "val", "size_u64"),
                            cast("val", E.U64, "val"),
                            ret("val", "env", "continuation",
                                "makethunk")))))),
            (Op2.Product, _num_u64_dispatch(
                block(
                    mul("val", "evaled_arg", "result"),
                    ret("val", "env", "continuation", "makethunk")),
                block(
                    mul("val", "evaled_arg", "result"),
                    trunc("trunc_", "val", 64),
                    cast("cast_", E.U64, "trunc_"),
                    ret("cast_", "env", "continuation", "makethunk")))),
            (Op2.Quotient, block(
                eq_val("is_z", "result", "zero"),
                or_("acc_err", "is_z", "args_num_type_eq_nil"),
                if_("acc_err", err4, block(match_tag("args_num_type", [
                    (E.Num, block(
                        div("val", "evaled_arg", "result"),
                        ret("val", "env", "continuation", "makethunk"))),
                    (E.U64, block(
                        div_rem64("divv", "_rem", "evaled_arg", "result"),
                        cast("divv", E.U64, "divv"),
                        ret("divv", "env", "continuation", "makethunk"))),
                ]))))),
            (Op2.Modulo, block(
                eq_val("is_z", "result", "zero"),
                not_("is_not_z", "is_z"),
                eq_tag("args_num_type_is_num", "args_num_type", "u64"),
                and_("acc_ok", "is_not_z", "args_num_type_is_num"),
                if_("acc_ok", block(
                    div_rem64("_div", "rem", "evaled_arg", "result"),
                    cast("rem", E.U64, "rem"),
                    ret("rem", "env", "continuation", "makethunk")),
                    err4))),
            (Op2.NumEqual, block(
                if_("args_num_type_eq_nil", err4, block(
                    eq_val("eq", "evaled_arg", "result"),
                    if_("eq",
                        block(ret("t", "env", "continuation",
                                  "makethunk")),
                        block(ret("nil", "env", "continuation",
                                  "makethunk"))))))),
            (Op2.Less, block(
                if_("args_num_type_eq_nil", err4, block(
                    lt("val", "evaled_arg", "result"),
                    if_("val",
                        block(ret("t", "env", "continuation",
                                  "makethunk")),
                        block(ret("nil", "env", "continuation",
                                  "makethunk"))))))),
            (Op2.Greater, block(
                if_("args_num_type_eq_nil", err4, block(
                    lt("val", "result", "evaled_arg"),
                    if_("val",
                        block(ret("t", "env", "continuation",
                                  "makethunk")),
                        block(ret("nil", "env", "continuation",
                                  "makethunk"))))))),
            (Op2.LessEqual, block(
                if_("args_num_type_eq_nil", err4, block(
                    lt("val", "result", "evaled_arg"),
                    if_("val",
                        block(ret("nil", "env", "continuation",
                                  "makethunk")),
                        block(ret("t", "env", "continuation",
                                  "makethunk"))))))),
            (Op2.GreaterEqual, block(
                if_("args_num_type_eq_nil", err4, block(
                    lt("val", "evaled_arg", "result"),
                    if_("val",
                        block(ret("nil", "env", "continuation",
                                  "makethunk")),
                        block(ret("t", "env", "continuation",
                                  "makethunk"))))))),
        ], err4),
    )

    if_cont_block = block(
        decons4("unevaled_args", "args_env", "continuation", "_foo", "cont"),
        call(["arg1", "more"], ccs, ["unevaled_args"]),
        call(["arg2", "end"], ccs, ["more"]),
        match_tag("end", [
            (E.Nil, block(match_tag("result", [
                (E.Nil,
                 block(ret("arg2", "args_env", "continuation", "ret"))),
            ], block(ret("arg1", "args_env", "continuation", "ret"))))),
        ], block(ret("arg1", "env", "err", "errctrl"))),
    )

    cproc_cont_block = block(
        decons4("cproc_name", "args", "saved_env", "cont", "cont"),
        decons2("unevaled_args", "evaluated_args", "args"),
        # accumulate the evaluated arg (`result`)
        cons2("evaluated_args", E.Cons, "result", "evaluated_args"),
        match_tag("unevaled_args", [
            (E.Nil, block(
                call(["expr", "env2", "cont2", "ctrl2"], choose_cproc_call,
                     ["cproc_name", "evaluated_args", "saved_env", "cont"]),
                ret("expr", "env2", "cont2", "ctrl2"))),
            (E.Cons, block(
                decons2("arg", "unevaled_args", "unevaled_args"),
                cons2("args", E.Cons, "unevaled_args", "evaluated_args"),
                cons4("cont", C.Cproc, "cproc_name", "args", "saved_env",
                      "cont"),
                ret("arg", "saved_env", "cont", "ret"))),
        ]),
    )

    apply_branch = block(
        sym("makethunk", "make-thunk"),
        sym("errctrl", "error"),
        sym("ret", "return"),
        sym("t", "t"),
        sym("nil", "nil"),
        cast("nil", E.Nil, "nil"),
        zero("empty_env", E.Env),
        lit_str("empty_str", ""),
        lit_num("zero", 0),
        zero("foo", E.Nil),
        zero("char", E.Char),
        zero("u64", E.U64),
        h8z("err", C.Error),
        match_tag("cont", [
            (C.Outermost, outermost_block),
            (C.StreamDispatch, stream_dispatch_block),
            (C.Emit, emit_block),
            (C.Call, call_block),
            (C.Call2, call2_block),
            (C.Let, let_block),
            (C.LetRec, letrec_block),
            (C.Unop, unop_block),
            (C.Binop, binop_block),
            (C.Binop2, binop2_block),
            (C.If, if_cont_block),
            (C.Cproc, cproc_cont_block),
        ]),
    )

    body = block(
        ir.MatchValue("ctrl", ir.LIT_SYMBOL, (
            (Lit.symbol(lurk_sym("apply-continuation")), apply_branch),
        ), Block((), ir.Return(("result", "env", "cont", "ctrl")))),
    )
    return mk_func("apply_cont", ["result", "env", "cont", "ctrl"], 4, body)


# ---------------------------------------------------------------------------
# make_thunk (eval.rs:1915-1938)
# ---------------------------------------------------------------------------


def _make_thunk() -> ir.Func:
    body = block(
        ir.MatchValue("ctrl", ir.LIT_SYMBOL, (
            (Lit.symbol(lurk_sym("make-thunk")), block(
                zero("empty_env", E.Env),
                match_tag("cont", [
                    (C.Outermost, block(
                        h8z("term", C.Terminal),
                        ret("expr", "empty_env", "term"))),
                    (C.StreamDispatch, block(
                        h8z("pause", C.StreamPause),
                        ret("expr", "empty_env", "pause"))),
                ], block(
                    cons2("thunk", E.Thunk, "expr", "cont"),
                    h8z("dummy", C.Dummy),
                    ret("thunk", "env", "dummy"))))),
        ), Block((), ir.Return(("expr", "env", "cont")))),
    )
    return mk_func("make_thunk", ["expr", "env", "cont", "ctrl"], 3, body)


# ---------------------------------------------------------------------------
# step assembly (eval.rs:408-432)
# ---------------------------------------------------------------------------

_EVAL_STEP_CACHE = {}


def make_eval_step(cprocs: Sequence[Tuple[Symbol, int]] = (),
                   ivc: bool = True) -> ir.Func:
    key = (tuple(cprocs), ivc)
    cached = _EVAL_STEP_CACHE.get(key)
    if cached is not None:
        return cached
    reduce_f = _reduce(cprocs)
    apply_cont_f = _apply_cont(cprocs, ivc)
    make_thunk_f = _make_thunk()
    step = mk_func("step", ["expr", "env", "cont"], 3, block(
        call(["expr", "env", "cont", "ctrl"], reduce_f,
             ["expr", "env", "cont"]),
        call(["expr", "env", "cont", "ctrl"], apply_cont_f,
             ["expr", "env", "cont", "ctrl"]),
        call(["expr", "env", "cont"], make_thunk_f,
             ["expr", "env", "cont", "ctrl"]),
        ret("expr", "env", "cont"),
    ))
    _EVAL_STEP_CACHE[key] = step
    return step


def eval_step() -> ir.Func:
    """Default step function: IVC, no coprocessors (eval.rs:33-37)."""
    return make_eval_step((), True)
