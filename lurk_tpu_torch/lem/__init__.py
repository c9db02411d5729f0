"""LEM: the Lurk Evaluation Model layer.

Authoring IR (:mod:`.ir`), slot analysis (:mod:`.slots`), the interpreter
(:mod:`.interpreter`), the universal Lurk step function
(:mod:`.eval_step`) and the evaluation drivers (:mod:`.evaluation`).
"""

from .evaluation import (  # noqa: F401
    Coprocessor, Lang, LangSetup, build_frames, evaluate, evaluate_simple,
    evaluate_with_env, get_pc, resume_stream, start_stream,
)
from .eval_step import eval_step, make_cprocs_funcs, make_eval_step  # noqa: F401
from .interpreter import Channel, Frame, Hints, dummy_channel  # noqa: F401
