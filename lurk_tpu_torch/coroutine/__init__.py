"""Memoset coroutines: memoized, deferred proofs of (mutually recursive)
queries with a LogUp multiset and a Fiat-Shamir transcript built as a
Lurk list (the port of the JAX package's ``coroutine/``): the
evaluation-time ``Scope``, the coroutine circuits, the env and
``Toplevel`` queries, and the two memoset provers (NIVC and the
SuperNova cycle)."""
