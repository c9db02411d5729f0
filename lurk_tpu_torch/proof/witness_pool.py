"""The fork pool of step witnesses, shared by both cycle provers.

A step function's witness depends only on its chunk (z_in and the
frames), not on the fold's accumulators, so while the parent folds, a
pool of forked workers synthesizes every step's segment ahead (the
reference's witness-gen ∥ folding pipeline, src/proof/nova.rs:297-332
and supernova.rs:248-285; the JAX package's ``prover_cycle.py`` and
``prover_supernova_cycle.py`` each keep a copy, the port this one).

The pool runs whenever ``check_steps`` is off and there are at least 3
chunks (:func:`uses_pool`). The store is hydrated before the fork, so a
worker touches no CUDA tensor (it would raise: CUDA cannot start again
in a forked child) and no torch op; jobs are bare indices into state the
workers inherit, and results are packed aux segments. A worker's
exception, or a worker's death, fails the prove: nothing falls back to
inline synthesis.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..fields import FieldSpec
from ..hostlib.fastpack import pack_ints, unpack_ints
from ..r1cs.cs import ConstraintSystem
from ..r1cs.gadgets import Num, alloc_num
from ..store.core import Store
from ..utils import tracing

# (field, step function, jobs, the fork span's context) while a pool
# runs: the forked workers read it, so nothing but the job's index is
# pickled
_POOL_ARGS: Optional[tuple] = None


def uses_pool(check_steps: bool, n_chunks: int) -> bool:
    return not check_steps and n_chunks >= 3


def _values(out):
    """The values of a step function's Nums, nested as it returned
    them."""
    if isinstance(out, Num):
        return out.value
    return type(out)(_values(o) for o in out)


def step_witness(field: FieldSpec, step_fn: Callable, z_in: Sequence[int],
                 step_aux: Any) -> Tuple[np.ndarray, Any]:
    """One step function's witness-only synthesis on ``z_in``: its aux
    segment (packed) and its outputs' values."""
    cs = ConstraintSystem(field, witness_only=True)
    zi = [alloc_num(cs, v) for v in z_in]
    n0 = len(cs.aux)
    out = step_fn(cs, zi, step_aux)
    return pack_ints(cs.aux[n0:]), _values(out)


def unpack_segment(packed: np.ndarray) -> List[int]:
    return unpack_ints(packed, packed.size // 4)


def step_witnesses(store: Store, step_fn: Callable,
                   jobs: List[Tuple[Sequence[int], Any]],
                   check_steps: bool) -> Iterator[Optional[tuple]]:
    """One item a job ``(z_in, step_aux)``, in order: ``(aux segment,
    output values)`` from the pool, or None each (inline synthesis)
    when the pool does not run.

    Spans: ``witness_pool.fork`` (creating the pool and submitting every
    job, which forks the workers), ``witness_pool.synthesize`` in the
    worker (job k's synthesis, with its CPU seconds; its records come
    back with the result) and ``witness_pool.wait`` (taking job k's
    result and unpacking it)."""
    if not uses_pool(check_steps, len(jobs)):
        for _ in jobs:
            yield None
        return
    global _POOL_ARGS
    store.hydrate_z_cache()           # no hashing may be left to a child
    ctx = multiprocessing.get_context("fork")
    n_proc = min(len(jobs), max(1, (ctx.cpu_count() or 2) - 1))
    pool = None
    try:
        with tracing.span("witness_pool.fork", workers=n_proc,
                          tasks=len(jobs)):
            _POOL_ARGS = (store.field, step_fn, jobs, tracing.context())
            pool = ProcessPoolExecutor(n_proc, mp_context=ctx)
            futures = [pool.submit(_worker, k) for k in range(len(jobs))]
        for k, fut in enumerate(futures):
            with tracing.span("witness_pool.wait", step=k):
                packed, outs, recs = fut.result()
                tracing.merge(recs)
                seg = unpack_segment(packed)
            yield seg, outs
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        _POOL_ARGS = None


def _worker(k: int):
    field, step_fn, jobs, span_ctx = _POOL_ARGS
    z_in, step_aux = jobs[k]
    with tracing.adopt(span_ctx), \
            tracing.span("witness_pool.synthesize", cpu=True, step=k):
        packed, outs = step_witness(field, step_fn, z_in, step_aux)
    return packed, outs, tracing.take()
