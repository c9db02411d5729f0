"""Evaluation drivers: frame building over the step function.

Parity: reference src/lem/eval.rs:39-150 (get_pc, compute_frame,
build_frames, traverse_frames) and the `evaluate*` family (:152-366).
`Lang` mirrors src/lang.rs:59-152 — an ordered map Symbol -> coprocessor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..store.core import TUPLE2, Ptr, Store
from ..symbol import Symbol
from ..tags import ContTag, ExprTag
from . import ir
from .eval_step import eval_step, make_cprocs_funcs, make_eval_step
from .interpreter import Channel, Frame, Interpreter, dummy_channel


@dataclasses.dataclass
class Coprocessor:
    """Evaluation side of a coprocessor (src/coprocessor/mod.rs:29-49).

    ``evaluate(store, args) -> Ptr`` consumes `arity` evaluated argument
    pointers and returns the result expression. ``evaluate_internal``
    plumbs env/cont through unchanged unless the coprocessor overrides it.
    ``circuit`` optionally carries the CoCircuit synthesis object (with a
    ``synthesize(synthesizer, not_dummy, inp) -> [AllocatedPtr]``
    method); without it the circuit consumes the evaluated result as
    non-deterministic advice.
    """

    arity: int
    evaluate: Callable[[Store, List[Ptr]], Ptr]
    circuit: Optional[object] = None

    def evaluate_internal(self, store: Store,
                          ptrs: List[Ptr]) -> List[Ptr]:
        args, env, cont = ptrs[:self.arity], ptrs[-2], ptrs[-1]
        return [self.evaluate(store, args), env, cont]


class Lang:
    """Ordered coprocessor registry (src/lang.rs)."""

    def __init__(self):
        self._coprocs: Dict[Symbol, Coprocessor] = {}

    def add_coprocessor(self, sym: Symbol, coproc: Coprocessor) -> None:
        self._coprocs[sym] = coproc

    def coprocessors(self) -> List[Tuple[Symbol, Coprocessor]]:
        return list(self._coprocs.items())

    def cproc_specs(self) -> List[Tuple[Symbol, int]]:
        return [(s, c.arity) for s, c in self._coprocs.items()]

    def index_by_symbol(self, sym: Symbol) -> Optional[int]:
        for i, s in enumerate(self._coprocs):
            if s == sym:
                return i
        return None

    def lookup(self, sym: Symbol) -> Optional[Coprocessor]:
        return self._coprocs.get(sym)

    def interpreter_cprocs(self) -> Dict[Symbol, Callable]:
        return {
            s: (lambda store, args, _c=c: _c.evaluate_internal(store, args))
            for s, c in self._coprocs.items()
        }

    def circuit_synthesizers(self) -> Dict[Symbol, object]:
        return {s: c.circuit for s, c in self._coprocs.items()
                if c.circuit is not None}

    def __len__(self) -> int:
        return len(self._coprocs)


@dataclasses.dataclass
class LangSetup:
    """(lurk_step, cprocs, lang) bundle for NIVC/IVC evaluation."""

    lurk_step: ir.Func
    cprocs: List[ir.Func]
    lang: Lang

    @staticmethod
    def ivc(lang: Lang) -> "LangSetup":
        return LangSetup(make_eval_step(tuple(lang.cproc_specs()), True),
                         [], lang)

    @staticmethod
    def nivc(lang: Lang) -> "LangSetup":
        specs = tuple(lang.cproc_specs())
        return LangSetup(make_eval_step(specs, False),
                         make_cprocs_funcs(specs), lang)


def get_pc(expr: Ptr, store: Store, lang: Lang) -> int:
    """NIVC program counter from a Cproc expression (eval.rs:39-57)."""
    if expr.tag == ExprTag.Cproc and expr.kind == TUPLE2:
        cproc, _ = store.tuple2[expr.idx]
        cproc_sym = store.fetch_symbol(cproc)
        assert cproc_sym is not None, "Cproc expression is not interned"
        idx = lang.index_by_symbol(cproc_sym)
        assert idx is not None, "Coprocessor not found"
        return idx + 1
    return 0


_TERMINAL_TAGS = frozenset(
    {ContTag.Terminal, ContTag.Error, ContTag.StreamPause})


def compute_frame(lurk_step: ir.Func, cprocs: Sequence[ir.Func],
                  inp: List[Ptr], store: Store, lang: Lang,
                  channel: Channel, pc: int) -> Tuple[Frame, bool]:
    func = lurk_step if pc == 0 else cprocs[pc - 1]
    assert len(func.input_params) == len(inp)
    interp = Interpreter(store, lang.interpreter_cprocs())
    frame = interp.call(func, inp, channel, pc=pc)
    must_break = frame.output[2].tag in _TERMINAL_TAGS
    return frame, must_break


def build_frames(lurk_step: ir.Func, cprocs: Sequence[ir.Func],
                 inp: List[Ptr], store: Store, limit: int, lang: Lang,
                 channel: Channel) -> List[Frame]:
    pc = 0
    frames: List[Frame] = []
    for _ in range(limit):
        frame, must_break = compute_frame(
            lurk_step, cprocs, inp, store, lang, channel, pc)
        inp = list(frame.output)
        frames.append(frame)
        if must_break:
            break
        pc = get_pc(frame.output[0], store, lang)
    return frames


def traverse_frames(lurk_step: ir.Func, cprocs: Sequence[ir.Func],
                    inp: List[Ptr], store: Store, limit: int, lang: Lang,
                    channel: Channel) -> Tuple[List[Ptr], int]:
    """Faster build_frames that doesn't accumulate frames."""
    pc = 0
    iterations = 0
    for _ in range(limit):
        frame, must_break = compute_frame(
            lurk_step, cprocs, inp, store, lang, channel, pc)
        iterations += 1
        inp = list(frame.output)
        if must_break:
            break
        pc = get_pc(frame.output[0], store, lang)
    return inp, iterations


def _setup(lang_setup: Optional[LangSetup]):
    if lang_setup is None:
        return eval_step(), [], Lang()
    return lang_setup.lurk_step, lang_setup.cprocs, lang_setup.lang


def evaluate_with_env_and_cont(lang_setup: Optional[LangSetup], expr: Ptr,
                               env: Ptr, cont: Ptr, store: Store,
                               limit: int,
                               channel: Optional[Channel] = None
                               ) -> List[Frame]:
    step, cprocs, lang = _setup(lang_setup)
    channel = channel or dummy_channel()
    return build_frames(step, cprocs, [expr, env, cont], store, limit,
                        lang, channel)


def evaluate_with_env(lang_setup: Optional[LangSetup], expr: Ptr, env: Ptr,
                      store: Store, limit: int,
                      channel: Optional[Channel] = None) -> List[Frame]:
    return evaluate_with_env_and_cont(
        lang_setup, expr, env, store.cont_outermost(), store, limit,
        channel)


def evaluate(lang_setup: Optional[LangSetup], expr: Ptr, store: Store,
             limit: int, channel: Optional[Channel] = None) -> List[Frame]:
    return evaluate_with_env_and_cont(
        lang_setup, expr, store.intern_empty_env(), store.cont_outermost(),
        store, limit, channel)


def evaluate_simple_with_env_and_cont(lang_setup: Optional[LangSetup],
                                      expr: Ptr, env: Ptr, cont: Ptr,
                                      store: Store, limit: int,
                                      channel: Optional[Channel] = None
                                      ) -> Tuple[List[Ptr], int]:
    step, cprocs, lang = _setup(lang_setup)
    channel = channel or dummy_channel()
    return traverse_frames(step, cprocs, [expr, env, cont], store, limit,
                           lang, channel)


def evaluate_simple(lang_setup: Optional[LangSetup], expr: Ptr,
                    store: Store, limit: int,
                    channel: Optional[Channel] = None
                    ) -> Tuple[List[Ptr], int]:
    return evaluate_simple_with_env_and_cont(
        lang_setup, expr, store.intern_empty_env(), store.cont_outermost(),
        store, limit, channel)


def start_stream(lang_setup: Optional[LangSetup], callable_: Ptr,
                 store: Store, limit: int,
                 channel: Channel) -> List[Frame]:
    return evaluate_with_env_and_cont(
        lang_setup, callable_, store.intern_empty_env(),
        store.cont_stream_start(), store, limit, channel)


def resume_stream(lang_setup: Optional[LangSetup], inp: List[Ptr],
                  store: Store, limit: int,
                  channel: Channel) -> List[Frame]:
    assert inp[2].tag == ContTag.StreamPause
    step, cprocs, lang = _setup(lang_setup)
    return build_frames(step, cprocs, list(inp), store, limit, lang,
                        channel)
