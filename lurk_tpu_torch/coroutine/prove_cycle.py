"""MemosetCycleProver: memoset coroutines on the SuperNova cycle.

The port of the JAX package's ``coroutine/prove_cycle.py``: the
O(#indices) analogue of :mod:`.prove`. Each CoroutineCircuit chunk is
the step function of one SuperNova augmented circuit
(:mod:`..proof.supernova_cycle`), as the reference rides arecibo's
supernova (prove.rs:59-147): a chain may start at any circuit index
(``base_allowed``), and the shapes are synthesized, not cached on disk.
z = the 6 memoset pointers (12 scalars); the verifier also checks the
final LogUp state: acc == (Num, 0) and transcript digest == r.

Both curves commit on the prover's ``device`` (default ``cuda``). The
in-memory public parameters are keyed by the circuits (the query's
``circuits_key``: for a ``Toplevel``, a digest of its coroutines' LEM
bodies), where the JAX package keys them by the query class's name and
the count of circuits, so that two toplevels of one size share nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..device import resolve_device
from ..fields import FieldSpec
from ..lem.circuit import AllocatedPtr
from ..proof.supernova_cycle import (
    SnCycleProof, SnCyclePublicParams, SnCycleSNARK,
    verify as sn_cycle_verify,
)
from ..r1cs.gadgets import alloc_num
from .circuit import CoroutineCircuit
from .memoset import Scope
from .prove import COROUTINE_ARITY, MemosetProver, final_state_ok


def _coroutine_step(cs, zi, aux):
    """step(cs, zi_nums, aux=(CoroutineCircuit, next_index))."""
    circuit, next_idx = aux
    ptrs = [AllocatedPtr(zi[2 * i], zi[2 * i + 1]) for i in range(6)]
    outs = circuit.synthesize_with_inputs(cs, ptrs)
    flat = []
    for ptr in outs:
        flat.extend((ptr.tag, ptr.hash))
    return flat, alloc_num(cs, next_idx)


_PP_CACHE: Dict[tuple, SnCyclePublicParams] = {}


class MemosetCycleProver(MemosetProver):
    """Prove a finalized Scope with O(#indices) proof size."""

    def params_key(self, field: FieldSpec, n_circuits: int) -> tuple:
        """The key of the in-memory public parameters."""
        return (field.name, self.rc, self.circuit_query.circuits_key(),
                n_circuits, resolve_device(self.device))

    def public_params(self, scope: Scope, n_circuits: int
                      ) -> SnCyclePublicParams:
        """The public parameters of ``n_circuits`` coroutine circuits,
        built at the first call and then taken from memory."""
        s = scope.store
        key = self.params_key(s.field, n_circuits)
        pp = _PP_CACHE.get(key)
        if pp is not None:
            return pp
        dummy_auxes = [
            (CoroutineCircuit(scope, [], index, self.rc,
                              self.circuit_query.for_index(index)), 0)
            for index in range(n_circuits)]
        pp = SnCyclePublicParams.setup(
            s.field, COROUTINE_ARITY, [_coroutine_step] * n_circuits,
            self.z0(scope), dummy_auxes, device=self.device,
            base_allowed=True)
        _PP_CACHE[key] = pp
        return pp

    def prove_from_scope(self, scope: Scope
                         ) -> Tuple[SnCyclePublicParams, SnCycleProof]:
        steps = self.steps(scope)
        indices = sorted(scope.unique_inserted_keys)
        n_circuits = (max(indices) + 1) if indices else 1
        pp = self.public_params(scope, n_circuits)
        z = self.z0(scope)
        snark = SnCycleSNARK(pp, z,
                             initial_pc=steps[0].index if steps else 0)
        tr_ptr = scope.init_transcript_ptr()
        for k, step in enumerate(steps):
            z_out, tr_ptr = self.next_z(scope, step, z, tr_ptr)
            next_idx = steps[k + 1].index if k + 1 < len(steps) else 0
            snark.prove_step(step.index, z_out, next_idx,
                             step_aux=(step, next_idx),
                             check=self.check_steps)
            z = z_out
        return pp, snark.finish()


def verify(pp: SnCyclePublicParams, proof: SnCycleProof) -> bool:
    """SuperNova cycle verification + the memoset's final-state checks."""
    return sn_cycle_verify(pp, proof) and final_state_ok(proof.z0,
                                                         proof.zn)
