"""The reference's headline workload: the infinite-stream Fibonacci
program (benches/common/fib.rs), run for ``fib_limit(n, rc)`` frames,
the trie coprocessor's program (benches/trie_nivc.rs), and the sample
toplevel of memoset coroutines (src/lem/coroutine/toplevel.rs:273-350).

Copies of the programs and frame model of the JAX package's
``examples/fib.py`` and ``examples/benches.py``, and of the LEM of its
``tests/test_toplevel.py``, so that the port's smoke run needs nothing
outside this package.
"""

FIB_PROGRAM = """
(letrec ((next (lambda (a b) (next b (+ a b))))
         (fib (next 0 1)))
  (fib))
"""

LIN_COEF = 7
ANG_COEF = 7


def fib_frame(n: int) -> int:
    return LIN_COEF + ANG_COEF * n


def fib_limit(n: int, rc: int) -> int:
    """Frames for ``n`` iterations, rounded up to a multiple of ``rc``."""
    frame = fib_frame(n)
    return rc * (frame // rc + (1 if frame % rc else 0))


# The trie coprocessor's program (the reference's benches/trie_nivc.rs,
# the JAX package's ``examples/benches.py`` TRIE_CODE): it inserts
# fib(40) and fib(50) into a trie and sums their lookups. Run under
# ``LangSetup.nivc`` with ``coproc.trie.install_trie_lang()``: 1,590
# frames, 5 of them coprocessor frames.
TRIE_PROGRAM = """
(let ((fib (letrec ((next (lambda (a b n target)
               (if (eq n target)
                   a
                   (next b
                         (+ a b)
                         (+ 1 n)
                         target))))
            (fib (next 0 1 0)))
          fib))
      (fib-trie (.lurk.trie.new))
      (fib-trie (.lurk.trie.insert fib-trie 40 (fib 40)))
      (fib-trie (.lurk.trie.insert fib-trie 50 (fib 50))))
  (+ (num (.lurk.trie.lookup fib-trie 40)) (num (.lurk.trie.lookup fib-trie 50))))"""
TRIE_RESULT = 12688603180


def sample_toplevel():
    """The factorial, even and odd coroutines in LEM, in that order (the
    reference's lem_coroutine_eval_test): (toplevel, factorial, even,
    odd symbols). even and odd call each other through ``Op::Crout``."""
    from .coroutine.toplevel import Toplevel
    from .lem import ir
    from .lem.eval_step import eq_val, lit_num, mul, sub
    from .symbol import user_sym

    factorial_sym = user_sym("factorial")
    even_sym = user_sym("even")
    odd_sym = user_sym("odd")
    factorial = ir.Func(
        "factorial", ("n",), 1,
        ir.block(
            lit_num("zero", 0),
            lit_num("one", 1),
            eq_val("n_is_zero", "n", "zero"),
            ir.if_(
                "n_is_zero",
                ir.block(ir.ret("one")),
                ir.block(
                    sub("m", "n", "one"),
                    (ir.CROUT, ("p",), factorial_sym, ("m",)),
                    mul("res", "n", "p"),
                    ir.ret("res"),
                ))))
    even = ir.Func(
        "even", ("n",), 1,
        ir.block(
            lit_num("zero", 0),
            lit_num("one", 1),
            eq_val("n_is_zero", "n", "zero"),
            ir.if_(
                "n_is_zero",
                ir.block(ir.ret("one")),
                ir.block(
                    sub("m", "n", "one"),
                    (ir.CROUT, ("res",), odd_sym, ("m",)),
                    ir.ret("res"),
                ))))
    odd = ir.Func(
        "odd", ("n",), 1,
        ir.block(
            lit_num("zero", 0),
            eq_val("n_is_zero", "n", "zero"),
            ir.if_(
                "n_is_zero",
                ir.block(ir.ret("zero")),
                ir.block(
                    lit_num("one", 1),
                    sub("m", "n", "one"),
                    (ir.CROUT, ("res",), even_sym, ("m",)),
                    ir.ret("res"),
                ))))
    toplevel = Toplevel([
        (factorial_sym, factorial),
        (even_sym, even),
        (odd_sym, odd),
    ])
    return toplevel, factorial_sym, even_sym, odd_sym
