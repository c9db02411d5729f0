from .core import (  # noqa: F401
    ATOM, COMPACT, TUPLE2, TUPLE3, TUPLE4,
    PoseidonMemo, Ptr, Store, ZPtr,
)
