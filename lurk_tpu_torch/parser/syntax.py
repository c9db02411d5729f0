"""Lurk reader: hand-rolled recursive-descent parser.

Grammar parity with the reference's nom parser (src/parser/syntax.rs,
string.rs, base.rs):
  - symbols: relative (``foo.bar``), absolute (``.foo.bar``, ``:key``),
    raw (``~(foo bar)``), escaped limbs (``|...|``), char escapes
  - numbers: optional ``-``, base prefixes ``0b/0o/0d/0x``, ``u64`` / ``i64``
    suffixes, field-sized literals with overflow wrap, fractions ``a/b``
    (field division)
  - strings with escapes, chars (``'a'`` and ``#\\a``)
  - proper/improper lists, ``'quote``
  - meta forms ``!(...)`` whose head resolves in the .lurk.meta package
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..fields import FieldSpec
from ..symbol import (
    ESCAPE_CHARS, LURK_WHITESPACE, State, Symbol, meta_package_symbol,
)


class ParseError(Exception):
    def __init__(self, msg: str, pos: int):
        super().__init__(f"{msg} at offset {pos}")
        self.pos = pos


# --- Syntax AST ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SynNum:
    value: int  # field element (already reduced mod p)


@dataclasses.dataclass(frozen=True)
class SynU64:
    value: int


@dataclasses.dataclass(frozen=True)
class SynChar:
    value: str


@dataclasses.dataclass(frozen=True)
class SynString:
    value: str


@dataclasses.dataclass(frozen=True)
class SynSymbol:
    value: Symbol


@dataclasses.dataclass(frozen=True)
class SynQuote:
    inner: "Syntax"


@dataclasses.dataclass(frozen=True)
class SynList:
    elements: Tuple["Syntax", ...]


@dataclasses.dataclass(frozen=True)
class SynImproper:
    elements: Tuple["Syntax", ...]
    last: "Syntax"


Syntax = Union[SynNum, SynU64, SynChar, SynString, SynSymbol, SynQuote,
               SynList, SynImproper]


_BASE_DIGITS = {
    "b": "01", "o": "01234567", "d": "0123456789", "x": "0123456789abcdef",
}
_SUFFIXES = ("u128", "u16", "u32", "u64", "u8",
             "i128", "i16", "i32", "i64", "i8")
_SYMBOL_BLOCKERS = ",~#(){}[]1234567890."


class Parser:
    def __init__(self, field: FieldSpec, state: State,
                 create_unknown_packages: bool = True):
        self.field = field
        self.state = state
        self.create_unknown = create_unknown_packages

    # -- low-level cursor helpers --

    def _skip_space(self, s: str, i: int) -> int:
        while True:
            while i < len(s) and s[i] in LURK_WHITESPACE:
                i += 1
            if i < len(s) and s[i] == ";":
                while i < len(s) and s[i] != "\n":
                    i += 1
                continue
            return i

    # -- entry points --

    def parse_syntax(self, s: str, i: int, meta: bool = False
                     ) -> Tuple[Syntax, int]:
        if i >= len(s):
            raise ParseError("unexpected end of input", i)
        c = s[i]
        if c == "(":
            return self._parse_list(s, i, meta)
        num = self._try_parse_numeric(s, i)
        if num is not None:
            return num
        sym = self._try_parse_symbol(s, i)
        if sym is not None:
            return sym
        if c == '"':
            return self._parse_string(s, i)
        if c == "'":
            return self._parse_quote(s, i)
        if s.startswith("#\\", i):
            return self._parse_hash_char(s, i)
        raise ParseError(f"unexpected character {c!r}", i)

    def parse_maybe_meta(self, s: str, i: int
                         ) -> Optional[Tuple[bool, Syntax, int]]:
        i = self._skip_space(s, i)
        if i >= len(s):
            return None
        meta = s[i] == "!"
        if meta:
            i += 1
        syn, i = self.parse_syntax(s, i, meta=meta)
        return meta, syn, i

    def read(self, s: str) -> Syntax:
        i = self._skip_space(s, 0)
        syn, _ = self.parse_syntax(s, i)
        return syn

    # -- numbers --

    def _try_parse_numeric(self, s: str, i: int
                           ) -> Optional[Tuple[Syntax, int]]:
        start = i
        neg = False
        if i < len(s) and s[i] == "-":
            neg = True
            i += 1
        base = "d"
        if i + 1 < len(s) and s[i] == "0" and s[i + 1] in "bodx":
            base = s[i + 1]
            i += 2
        digits_set = _BASE_DIGITS[base]
        j = i
        digits = []
        while j < len(s) and (s[j].lower() in digits_set or s[j] == "_"):
            if s[j] != "_":
                digits.append(s[j].lower())
            j += 1
        if not digits:
            return None
        digits = "".join(digits)
        radix = len(digits_set)
        # suffix?
        for suf in _SUFFIXES:
            if s.startswith(suf, j):
                j += len(suf)
                if suf == "u64":
                    if neg:
                        raise ParseError("Negative u64 invalid", start)
                    v = int(digits, radix)
                    if v >= (1 << 64):
                        raise ParseError("u64 overflow", start)
                    return SynU64(v), j
                if suf == "i64":
                    v = int(digits, radix)
                    if neg:
                        v = -v
                    lo, hi = -(1 << 63), (1 << 63) - 1
                    if not lo <= v <= hi:
                        raise ParseError("i64 overflow", start)
                    return SynU64(v % (1 << 64)), j
                raise ParseError(f"Numeric suffix {suf} not yet supported",
                                 start)
        p = self.field.modulus
        v = int(digits, radix) % p
        if neg:
            v = (-v) % p
        # fraction: a/b is field division
        if j < len(s) and s[j] == "/":
            k = j + 1
            denom_digits = []
            while k < len(s) and s[k].lower() in digits_set:
                denom_digits.append(s[k].lower())
                k += 1
            if denom_digits:
                denom = int("".join(denom_digits), radix) % p
                v = (v * self.field.inv(denom)) % p
                j = k
            else:
                j += 1  # bare trailing '/' consumed as Div suffix (ref parity)
        return SynNum(v), j

    # -- strings / chars --

    def _parse_escaped_char(self, s: str, i: int, delim: str,
                            must_escape: str) -> Tuple[str, int]:
        # s[i] == '\\'
        i += 1
        if i >= len(s):
            raise ParseError("dangling escape", i)
        c = s[i]
        if c == "u" and i + 1 < len(s) and s[i + 1] == "{":
            j = s.index("}", i + 2)
            code = int(s[i + 2:j], 16)
            return chr(code), j + 1
        simple = {"n": "\n", "r": "\r", "t": "\t", "b": "\x08",
                  "f": "\x0c", "\\": "\\", "/": "/", '"': '"', "'": "'"}
        if c in simple:
            return simple[c], i + 1
        if c == delim or c in must_escape:
            return c, i + 1
        raise ParseError(f"invalid escape \\{c}", i)

    def _parse_string_inner(self, s: str, i: int, delim: str,
                            whitespace: bool, must_escape: str,
                            require_one: bool) -> Tuple[str, int]:
        out: List[str] = []
        start = i
        while i < len(s):
            c = s[i]
            if c == "\\":
                # escaped whitespace elides
                if i + 1 < len(s) and s[i + 1] in LURK_WHITESPACE:
                    j = i + 1
                    while j < len(s) and s[j] in LURK_WHITESPACE:
                        j += 1
                    i = j
                    continue
                ch, i = self._parse_escaped_char(s, i, delim, must_escape)
                out.append(ch)
                continue
            if c == delim or c in must_escape:
                break
            if not whitespace and c in LURK_WHITESPACE:
                break
            out.append(c)
            i += 1
        if require_one and not out:
            raise ParseError("expected at least one character", start)
        return "".join(out), i

    def _parse_string(self, s: str, i: int) -> Tuple[Syntax, int]:
        assert s[i] == '"'
        text, j = self._parse_string_inner(s, i + 1, '"', True, "", False)
        if j >= len(s) or s[j] != '"':
            raise ParseError("unterminated string", i)
        return SynString(text), j + 1

    def _parse_hash_char(self, s: str, i: int) -> Tuple[Syntax, int]:
        i += 2  # consume #\
        if s.startswith("u{", i):
            j = s.index("}", i)
            return SynChar(chr(int(s[i + 2:j], 16))), j + 1
        if i >= len(s):
            raise ParseError("dangling #\\", i)
        return SynChar(s[i]), i + 1

    def _parse_quote(self, s: str, i: int) -> Tuple[Syntax, int]:
        # try 'c' char first
        try:
            text, j = self._parse_string_inner(s, i + 1, "'", True, "()'",
                                               True)
            if j < len(s) and s[j] == "'" and len(text) == 1:
                return SynChar(text), j + 1
        except (ParseError, ValueError):
            pass
        inner, j = self.parse_syntax(s, i + 1)
        return SynQuote(inner), j

    # -- symbols --

    def _parse_symbol_limb(self, s: str, i: int,
                           escape: str) -> Tuple[str, int]:
        if i < len(s) and s[i] == "|":
            text, j = self._parse_string_inner(s, i + 1, "|", True, "|",
                                               True)
            if j >= len(s) or s[j] != "|":
                raise ParseError("unterminated |symbol|", i)
            return text, j + 1
        if i < len(s) and s[i] == ".":
            return "", i
        return self._parse_string_inner(s, i, ".", False, escape, True)

    def _parse_symbol_limbs(self, s: str, i: int
                            ) -> Tuple[List[str], int]:
        path = []
        limb, i = self._parse_symbol_limb(s, i, ESCAPE_CHARS)
        path.append(limb)
        while i < len(s) and s[i] == ".":
            j = i + 1
            try:
                limb, j = self._parse_symbol_limb(s, j, ESCAPE_CHARS)
            except ParseError:
                i = j  # trailing dot consumed
                break
            path.append(limb)
            i = j
        return path, i

    def _try_parse_symbol(self, s: str, i: int
                          ) -> Optional[Tuple[Syntax, int]]:
        if i >= len(s):
            return None
        c = s[i]
        if s.startswith("~(", i) or s.startswith("~:(", i):
            is_key = s[i + 1] == ":"
            j = i + (3 if is_key else 2)
            path = []
            while True:
                j = self._skip_space(s, j)
                if j < len(s) and s[j] == ")":
                    j += 1
                    break
                limb, j = self._parse_symbol_limb_raw(s, j)
                path.append(limb)
            path.reverse()
            sym = self.state.intern_path(path, is_key, self.create_unknown)
            return SynSymbol(sym), j
        if c in (".", ":"):
            is_key = c == ":"
            path, j = self._parse_symbol_limbs(s, i + 1)
            sym = self.state.intern_path(path, is_key, self.create_unknown)
            return SynSymbol(sym), j
        if c in _SYMBOL_BLOCKERS or c in LURK_WHITESPACE or c in "\"'\\|;":
            return None
        path, j = self._parse_symbol_limbs(s, i)
        sym = self.state.intern_relative_path(path, self.create_unknown)
        return SynSymbol(sym), j

    def _parse_symbol_limb_raw(self, s: str, i: int) -> Tuple[str, int]:
        if i < len(s) and s[i] == "|":
            text, j = self._parse_string_inner(s, i + 1, "|", True, "|",
                                               True)
            if j >= len(s) or s[j] != "|":
                raise ParseError("unterminated |symbol|", i)
            return text, j + 1
        return self._parse_string_inner(s, i, " ", False, "|()", True)

    # -- lists --

    def _parse_list(self, s: str, i: int, meta: bool) -> Tuple[Syntax, int]:
        assert s[i] == "("
        i += 1
        elements: List[Syntax] = []
        if meta:
            saved = self.state.current_package
            self.state.set_current_package(meta_package_symbol())
            try:
                i = self._skip_space(s, i)
                head = self._try_parse_symbol(s, i)
                if head is None:
                    raise ParseError("meta form must start with a symbol", i)
                syn, i = head
                elements.append(syn)
            finally:
                self.state.set_current_package(saved)
        last = None
        while True:
            i = self._skip_space(s, i)
            if i >= len(s):
                raise ParseError("unterminated list", i)
            if s[i] == ")":
                i += 1
                break
            if s[i] == "." and not self._is_symbol_start_dot(s, i):
                # improper tail
                i = self._skip_space(s, i + 1)
                last, i = self.parse_syntax(s, i)
                i = self._skip_space(s, i)
                if i >= len(s) or s[i] != ")":
                    raise ParseError("expected ) after improper tail", i)
                i += 1
                break
            syn, i = self.parse_syntax(s, i)
            elements.append(syn)
        if last is not None:
            return SynImproper(tuple(elements), last), i
        return SynList(tuple(elements)), i

    def _is_symbol_start_dot(self, s: str, i: int) -> bool:
        """A '.' inside a list is an improper-tail marker iff followed by
        whitespace; '.foo' is an absolute symbol."""
        if i + 1 >= len(s):
            return False
        nxt = s[i + 1]
        return not (nxt in LURK_WHITESPACE or nxt == ")")
