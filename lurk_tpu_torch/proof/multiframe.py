"""MultiFrame: batching `rc` evaluation frames into one folding step.

A copy of the JAX package's ``proof/multiframe.py``. Parity: reference
src/lem/multiframe.rs:218-360 (from_frames
chunking + pad_frames stuttering) and :596-712 (chained frame synthesis —
the output allocations of frame i ARE the input allocations of frame
i+1). The step instance's public IO is X = z_in (6 scalars) || z_out (6):
tag/hash of (expr, env, cont) before and after the chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..lem import ir
from ..lem.circuit import (
    AllocatedPtr, synthesize_frame_with_inputs,
)
from ..lem.evaluation import Lang, compute_frame
from ..lem.interpreter import Channel, Frame, dummy_channel
from ..r1cs.cs import ConstraintSystem
from ..r1cs.gadgets import alloc_input_num, enforce_equal
from ..store.core import Ptr, Store
from ..tags import ContTag


def pad_frames(frames: List[Frame], lurk_step: ir.Func, rc: int,
               store: Store, lang: Optional[Lang] = None,
               channel: Optional[Channel] = None) -> List[Frame]:
    """Pad to a multiple of rc with stuttering frames computed from the
    last output (multiframe.rs:717-740). Terminal/Error states stutter
    for free in `reduce`."""
    if not frames:
        return frames
    n = len(frames)
    target = ((n + rc - 1) // rc) * rc
    if target == n:
        return frames
    lang = lang or Lang()
    channel = channel or dummy_channel()
    last_out = frames[-1].output
    if last_out[2].tag == ContTag.StreamPause:
        # a paused stream stutters when the channel says so
        # (multiframe.rs:717-740 pad via the stutter flag)
        channel.feed(store.intern_t())
    pad_frame, _ = compute_frame(lurk_step, [], list(last_out), store,
                                 lang, channel, 0)
    assert pad_frame.output == pad_frame.input, \
        "stuttering pad frame must be a fixed point"
    return frames + [pad_frame] * (target - n)


def chunk_frames(frames: List[Frame], rc: int) -> List[List[Frame]]:
    assert len(frames) % rc == 0
    return [frames[i:i + rc] for i in range(0, len(frames), rc)]


def io_scalars(store: Store, ptrs: List[Ptr]) -> List[int]:
    """z-vector of an IO triple: (tag, digest) per pointer — 6 scalars."""
    out = []
    for ptr in ptrs:
        z = store.hash_ptr(ptr)
        out.extend((z.tag, z.digest))
    return out


@dataclasses.dataclass
class MultiFrame:
    """One folding step: rc frames, chained."""

    frames: List[Frame]
    z_in: List[int]
    z_out: List[int]

    @staticmethod
    def from_frames(frames: List[Frame], rc: int, lurk_step: ir.Func,
                    store: Store, lang: Optional[Lang] = None
                    ) -> List["MultiFrame"]:
        padded = pad_frames(list(frames), lurk_step, rc, store, lang)
        out = []
        for chunk in chunk_frames(padded, rc):
            out.append(MultiFrame(
                chunk,
                io_scalars(store, chunk[0].input),
                io_scalars(store, chunk[-1].output),
            ))
        return out

    def synthesize(self, cs: ConstraintSystem, lurk_step: ir.Func,
                   store: Store,
                   cproc_synthesizers: Optional[Dict] = None) -> None:
        """Build the step circuit: public X = z_in || z_out, rc chained
        frame synthesis, boundary equality at the end."""
        z_in_nums = [alloc_input_num(cs, v) for v in self.z_in]
        z_out_nums = [alloc_input_num(cs, v) for v in self.z_out]
        current = [
            AllocatedPtr(z_in_nums[2 * i], z_in_nums[2 * i + 1])
            for i in range(3)
        ]
        for frame in self.frames:
            current = synthesize_frame_with_inputs(
                cs, lurk_step, store, frame, current, cproc_synthesizers)
        for i, ptr in enumerate(current):
            enforce_equal(cs, ptr.tag, z_out_nums[2 * i])
            enforce_equal(cs, ptr.hash, z_out_nums[2 * i + 1])

    def instance(self, lurk_step: ir.Func, store: Store,
                 shape_check: bool = False,
                 cproc_synthesizers: Optional[Dict] = None,
                 witness_only: bool = False
                 ) -> Tuple[List[int], List[int], ConstraintSystem]:
        """(x, w, cs) for the folding layer. With witness_only the
        Poseidon slots skip all linear-combination algebra and take the
        host C++ trace (WitnessCS parity, multiframe.rs:653-702) — the
        returned cs
        carries no shape. Witness equality with the full path is pinned
        by tests (the reference's keystone `mismatch` check,
        proof/tests/mod.rs:247-248)."""
        cs = ConstraintSystem(store.field, check=shape_check,
                              witness_only=witness_only)
        self.synthesize(cs, lurk_step, store, cproc_synthesizers)
        return cs.inputs[1:], list(cs.aux), cs


def io_chain_checker(z0: List[int], zi: List[int]):
    """Returns a callback for nova.verify enforcing step IO linkage."""

    def check(xs: List[List[int]]) -> bool:
        if not xs:
            return False
        if xs[0][:6] != list(z0):
            return False
        for prev, cur in zip(xs, xs[1:]):
            if prev[6:] != cur[:6]:
                return False
        return xs[-1][6:] == list(zi)

    return check
