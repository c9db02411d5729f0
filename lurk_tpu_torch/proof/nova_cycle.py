"""Host transcript mirrors of the cycle protocol's in-circuit gadgets.

The shared helpers of the JAX package's ``proof/nova_cycle.py``:
``cycle_fold_challenge``, ``cycle_state_hash`` and ``_default_relaxed``,
which the SuperNova cycle fold (:mod:`.supernova_cycle`) uses. Its Nova
cycle backend (``CyclePublicParams``, ``CycleSNARK``, ``verify``) is not
ported yet.

Two hash chains, h (primary) and g (secondary), with h_0 = g_0 = 0,
bind each step's state; the fold challenge and the state hash below are
what the augmented circuits (:mod:`.augmented`,
:mod:`.supernova_augmented`) recompute bit-exactly in-circuit.
"""

from __future__ import annotations

from typing import Sequence

from ..curves.weierstrass import Affine, Curve
from .nova import (
    R1CSInstance, RelaxedInstance, _absorb_relaxed, _absorb_strict,
)
from .transcript import Transcript


def cycle_fold_challenge(curve_other: Curve, pp_digest: int,
                         acc: RelaxedInstance, new: R1CSInstance,
                         comm_t: Affine,
                         extra: Sequence[int] = ()) -> int:
    """Fold challenge for the cycle protocol (the in-circuit
    fold_relaxed_gadget recomputes this bit-exactly). `extra` binds
    per-fold context (SuperNova: the circuit index)."""
    tr = Transcript(curve_other, b"nova.fold")
    tr.absorb(pp_digest)
    for v in extra:
        tr.absorb(v)
    _absorb_relaxed(tr, acc)
    _absorb_strict(tr, new)
    tr.absorb_point(comm_t)
    return tr.squeeze()


def cycle_state_hash(curve_other: Curve, pp_digest: int, i: int,
                     z0: Sequence[int], zi: Sequence[int],
                     acc: RelaxedInstance, link: int) -> int:
    """Chain state hash (in-circuit mirror: state_hash_gadget)."""
    tr = Transcript(curve_other, b"nova.state")
    tr.absorb(pp_digest)
    tr.absorb(i)
    for v in z0:
        tr.absorb(v)
    for v in zi:
        tr.absorb(v)
    _absorb_relaxed(tr, acc)
    tr.absorb_scalar(link)
    return tr.squeeze()


def _default_relaxed() -> RelaxedInstance:
    return RelaxedInstance(None, None, [0, 0], 0)
