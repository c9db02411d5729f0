"""The reference's headline workload: the infinite-stream Fibonacci
program (benches/common/fib.rs), run for ``fib_limit(n, rc)`` frames.

A copy of the program and frame model of the JAX package's
``examples/fib.py``, so that the port's smoke run needs nothing outside
this package.
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
