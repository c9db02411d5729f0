"""Hierarchical symbols, packages and reader/printer state.

Behavioral parity with the reference's src/symbol.rs, src/package.rs and
src/state.rs (symbol paths like ``.lurk.user.x``, keyword symbols, package
resolution for reading/printing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

KEYWORD_MARKER = ":"
SYM_SEPARATOR = "."
SYM_MARKER = "."
ESCAPE_CHARS = "|(){}[],.:'\\\""
LURK_WHITESPACE = '\t\n\x0b\x0c\r \x85\u200e\u200f\u2028\u2029₠\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u202f\u205f\u3000'


@dataclasses.dataclass(frozen=True)
class Symbol:
    path: Tuple[str, ...] = ()
    keyword: bool = False

    # -- constructors --
    @staticmethod
    def root_sym() -> "Symbol":
        return Symbol((), False)

    @staticmethod
    def root_key() -> "Symbol":
        return Symbol((), True)

    @staticmethod
    def sym(path: Sequence[str]) -> "Symbol":
        return Symbol(tuple(path), False)

    @staticmethod
    def key(path: Sequence[str]) -> "Symbol":
        return Symbol(tuple(path), True)

    # -- predicates / accessors --
    @property
    def is_root(self) -> bool:
        return not self.path

    def name(self) -> str:
        if self.is_root:
            raise ValueError("Root symbols don't have names")
        return self.path[-1]

    def direct_child(self, child: str) -> "Symbol":
        return Symbol(self.path + (child,), self.keyword)

    def direct_parent(self) -> Optional["Symbol"]:
        if self.is_root:
            return None
        return Symbol(self.path[:-1], self.keyword)

    def extend(self, children: Sequence[str]) -> "Symbol":
        return Symbol(self.path + tuple(children), self.keyword)

    def has_parent(self, parent: "Symbol") -> bool:
        if len(self.path) < len(parent.path):
            return False
        return all(a == b for a, b in zip(self.path, parent.path))

    # -- printing (parity with Symbol::fmt_to_string) --
    @staticmethod
    def fmt_path_component(xs: str) -> str:
        res = []
        for x in xs:
            if x in ESCAPE_CHARS:
                res.append("\\" + x)
            elif x in LURK_WHITESPACE:
                res.append("\\u{%x}" % ord(x))
            else:
                res.append(x)
        return "".join(res)

    def fmt_path_to_string(self) -> str:
        res = []
        for i, comp in enumerate(self.path):
            res.append(self.fmt_path_component(comp))
            if i + 1 < len(self.path) or comp == "":
                res.append(".")
        return "".join(res)

    def fmt_to_string(self) -> str:
        if self.keyword:
            return "~:()" if self.is_root else ":" + self.fmt_path_to_string()
        return "~()" if self.is_root else "." + self.fmt_path_to_string()

    def prints_as_absolute(self) -> bool:
        if not self.path:
            return False
        head = self.path[0]
        if head == "":
            return True
        c0 = head[0]
        if c0 in "~#1234567890.:[](){}\"\\" or c0.isspace() or ord(c0) < 32:
            return True
        if len(head) >= 2 and head[0] == "-" and head[1].isdigit():
            return True
        return False

    def __str__(self) -> str:
        return self.fmt_to_string()


LURK_PACKAGE_SYMBOL_NAME = "lurk"
USER_PACKAGE_SYMBOL_NAME = "user"
META_PACKAGE_SYMBOL_NAME = "meta"

LURK_PACKAGE_SYMBOLS_NAMES = [
    "atom", "begin", "car", "cdr", "char", "comm", "commit", "cons",
    "current-env", "emit", "empty-env", "eval", "eq", "hide", "if", "lambda",
    "let", "letrec", "nil", "num", "u64", "open", "quote", "secret",
    "strcons", "t", "+", "-", "*", "/", "%", "=", "<", ">", "<=", ">=",
]

META_PACKAGE_SYMBOLS_NAMES = [
    "def", "defrec", "load", "assert", "assert-eq", "assert-emitted",
    "assert-error", "commit", "hide", "fetch", "open", "clear", "set-env",
    "prove", "verify", "defpackage", "import", "in-package", "help", "call",
    "chain", "inspect", "inspect-full", "dump-data", "def-load-data",
    "defprotocol", "prove-protocol", "verify-protocol",
]


def lurk_sym(name: str) -> Symbol:
    return Symbol.sym([LURK_PACKAGE_SYMBOL_NAME, name])


def user_sym(name: str) -> Symbol:
    return Symbol.sym(
        [LURK_PACKAGE_SYMBOL_NAME, USER_PACKAGE_SYMBOL_NAME, name]
    )


def meta_package_symbol() -> Symbol:
    return lurk_sym(META_PACKAGE_SYMBOL_NAME)


class Package:
    def __init__(self, name: Symbol):
        self.name = name
        self.symbols: Dict[str, Symbol] = {}
        self.names: Dict[Symbol, str] = {}
        self.local: Set[Symbol] = set()

    def resolve(self, symbol_name: str) -> Optional[Symbol]:
        return self.symbols.get(symbol_name)

    def intern(self, symbol_name: str) -> Symbol:
        if symbol_name in self.symbols:
            return self.symbols[symbol_name]
        symbol = self.name.direct_child(symbol_name)
        self.symbols[symbol_name] = symbol
        self.names[symbol] = symbol_name
        self.local.add(symbol)
        return symbol

    def import_symbols(self, symbols: Sequence[Symbol]) -> None:
        names = []
        for symbol in symbols:
            name = symbol.name()
            resolved = self.resolve(name)
            if resolved is not None and resolved != symbol:
                raise ValueError(
                    f"{symbol} conflicts with {resolved}, already accessible"
                )
            names.append(name)
        for symbol, name in zip(symbols, names):
            self.symbols[name] = symbol
            self.names[symbol] = name

    def use_package(self, package: "Package") -> None:
        self.import_symbols(sorted(package.local, key=lambda s: s.path))

    def fmt_to_string(self, symbol: Symbol) -> str:
        name = self.names.get(symbol)
        if name is None:
            return symbol.fmt_to_string()
        return Symbol.fmt_path_component(name)


class State:
    def __init__(self, current_package: Symbol,
                 packages: Dict[Symbol, Package]):
        self.current_package = current_package
        self.symbol_packages = packages

    @staticmethod
    def new_with_package(package: Package) -> "State":
        return State(package.name, {package.name: package})

    def add_package(self, package: Package) -> None:
        self.symbol_packages[package.name] = package

    def set_current_package(self, name: Symbol) -> None:
        if name not in self.symbol_packages:
            raise ValueError(f"Package {name} not found")
        self.current_package = name

    def _current(self) -> Package:
        return self.symbol_packages[self.current_package]

    def resolve(self, symbol_name: str) -> Optional[Symbol]:
        return self._current().resolve(symbol_name)

    def intern(self, symbol_name: str) -> Symbol:
        return self._current().intern(symbol_name)

    def import_symbols(self, symbols: Sequence[Symbol]) -> None:
        self._current().import_symbols(symbols)

    def fmt_to_string(self, symbol: Symbol) -> str:
        return self._current().fmt_to_string(symbol)

    def _intern_fold(self, init: Symbol, path: Sequence[str],
                     create_unknown: bool) -> Symbol:
        acc = init
        for s in path:
            pkg = self.symbol_packages.get(acc)
            if pkg is not None:
                acc = pkg.intern(s)
            elif create_unknown:
                pkg = Package(acc)
                sym = pkg.intern(s)
                self.add_package(pkg)
                acc = sym
            else:
                raise ValueError(f"Package {acc} not found")
        return acc

    def intern_path(self, path: Sequence[str], keyword: bool,
                    create_unknown: bool = True) -> Symbol:
        return self._intern_fold(Symbol((), keyword), path, create_unknown)

    def intern_relative_path(self, path: Sequence[str],
                             create_unknown: bool = True) -> Symbol:
        return self._intern_fold(self.current_package, path, create_unknown)

    @staticmethod
    def init_lurk_state() -> "State":
        root_package = Package(Symbol.root_sym())
        keyword_package = Package(Symbol.root_key())
        lurk_package = Package(root_package.intern(LURK_PACKAGE_SYMBOL_NAME))
        for name in LURK_PACKAGE_SYMBOLS_NAMES:
            lurk_package.intern(name)
        meta_package = Package(lurk_package.intern(META_PACKAGE_SYMBOL_NAME))
        for name in META_PACKAGE_SYMBOLS_NAMES:
            meta_package.intern(name)
        user_package = Package(lurk_package.intern(USER_PACKAGE_SYMBOL_NAME))
        user_package.use_package(lurk_package)
        state = State.new_with_package(user_package)
        state.add_package(root_package)
        state.add_package(keyword_package)
        state.add_package(lurk_package)
        state.add_package(meta_package)
        return state


def initial_lurk_state() -> State:
    return State.init_lurk_state()
