"""Tag namespaces for Lurk values (parity with reference src/tag.rs).

All tag kinds share one u16 namespace: ExprTag at 0x0000, ContTag at 0x1000,
Op1 at 0x2000, Op2 at 0x3000. A tag's field embedding is its u16 value.
"""

from __future__ import annotations

from enum import IntEnum


class ExprTag(IntEnum):
    Nil = 0x0000
    Cons = 0x0001
    Sym = 0x0002
    Fun = 0x0003
    Num = 0x0004
    Thunk = 0x0005
    Str = 0x0006
    Char = 0x0007
    Comm = 0x0008
    U64 = 0x0009
    Key = 0x000A
    Cproc = 0x000B
    Env = 0x000C
    Rec = 0x000D
    Prov = 0x000E


class ContTag(IntEnum):
    Outermost = 0x1000
    Call0 = 0x1001
    Call = 0x1002
    Call2 = 0x1003
    Tail = 0x1004
    Error = 0x1005
    Lookup = 0x1006
    Unop = 0x1007
    Binop = 0x1008
    Binop2 = 0x1009
    If = 0x100A
    Let = 0x100B
    LetRec = 0x100C
    Dummy = 0x100D
    Terminal = 0x100E
    Emit = 0x100F
    Cproc = 0x1010
    StreamStart = 0x1011
    StreamDispatch = 0x1012
    StreamPause = 0x1013


class Op1(IntEnum):
    Car = 0x2000
    Cdr = 0x2001
    Atom = 0x2002
    Emit = 0x2003
    Open = 0x2004
    Secret = 0x2005
    Commit = 0x2006
    Num = 0x2007
    Comm = 0x2008
    Char = 0x2009
    Eval = 0x200A
    U64 = 0x200B


class Op2(IntEnum):
    Sum = 0x3000
    Diff = 0x3001
    Product = 0x3002
    Quotient = 0x3003
    Equal = 0x3004
    NumEqual = 0x3005
    Less = 0x3006
    Greater = 0x3007
    LessEqual = 0x3008
    GreaterEqual = 0x3009
    Cons = 0x300A
    StrCons = 0x300B
    Begin = 0x300C
    Hide = 0x300D
    Modulo = 0x300E
    Eval = 0x300F


TAG_KINDS = (ExprTag, ContTag, Op1, Op2)


def tag_from_u16(v: int):
    for kind in TAG_KINDS:
        try:
            return kind(v)
        except ValueError:
            continue
    raise ValueError(f"unknown tag value {v:#06x}")
