"""Reader entry points tying the parser to the store.

Parity: Store::read / read_maybe_meta / intern_syntax
(reference src/lem/store.rs:825-881).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..store.core import Ptr, Store
from ..symbol import State, lurk_sym
from .syntax import (  # noqa: F401
    ParseError, Parser, SynChar, SynImproper, SynList, SynNum, SynQuote,
    SynString, SynSymbol, SynU64, Syntax,
)


def intern_syntax(store: Store, syn: Syntax) -> Ptr:
    if isinstance(syn, SynNum):
        return store.num(syn.value)
    if isinstance(syn, SynU64):
        return store.u64(syn.value)
    if isinstance(syn, SynChar):
        return store.char(syn.value)
    if isinstance(syn, SynSymbol):
        return store.intern_symbol(syn.value)
    if isinstance(syn, SynString):
        return store.intern_string(syn.value)
    if isinstance(syn, SynQuote):
        return store.list([
            store.intern_symbol(lurk_sym("quote")),
            intern_syntax(store, syn.inner),
        ])
    if isinstance(syn, SynList):
        return store.list([intern_syntax(store, x) for x in syn.elements])
    if isinstance(syn, SynImproper):
        return store.improper_list(
            [intern_syntax(store, x) for x in syn.elements],
            intern_syntax(store, syn.last),
        )
    raise TypeError(f"unknown syntax node {syn!r}")


def read(store: Store, state: State, input_str: str) -> Ptr:
    parser = Parser(store.field, state)
    return intern_syntax(store, parser.read(input_str))


def read_maybe_meta(store: Store, state: State, input_str: str, pos: int = 0
                    ) -> Optional[Tuple[bool, Ptr, int]]:
    """Returns (is_meta, ptr, next_offset) or None at EOF."""
    parser = Parser(store.field, state)
    res = parser.parse_maybe_meta(input_str, pos)
    if res is None:
        return None
    meta, syn, nxt = res
    return meta, intern_syntax(store, syn), nxt


def read_with_default_state(store: Store, input_str: str) -> Ptr:
    return read(store, State.init_lurk_state(), input_str)
