"""The reference's headline workload: the infinite-stream Fibonacci
program (benches/common/fib.rs), run for ``fib_limit(n, rc)`` frames,
and the trie coprocessor's program (benches/trie_nivc.rs).

Copies of the programs and frame model of the JAX package's
``examples/fib.py`` and ``examples/benches.py``, so that the port's
smoke run needs nothing outside this package.
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
