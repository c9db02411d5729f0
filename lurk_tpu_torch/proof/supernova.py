"""SuperNova-style non-uniform IVC (NIVC): the frame chunking.

The part of the JAX package's ``proof/supernova.py`` that the cycle
prover (:mod:`.prover_supernova_cycle`) needs: ``chunk_frames_nivc``.
Its ``SuperNovaProver``, ``NivcProof`` and their compression are not
ported yet.

MultiFrame chunking follows reference multiframe.rs:300-360: IVC-style
chunks of `rc` frames at pc=0, broken at coprocessor frames (pc != 0),
which form singleton chunks proven against their own circuit.
"""

from __future__ import annotations

from typing import List

from ..lem.interpreter import Frame


def chunk_frames_nivc(frames: List[Frame], rc: int) -> List[List[Frame]]:
    """Chunks of up to rc pc=0 frames; pc!=0 frames are singletons
    (multiframe.rs:300-360)."""
    chunks: List[List[Frame]] = []
    acc: List[Frame] = []
    for frame in frames:
        if frame.pc == 0:
            acc.append(frame)
            if len(acc) == rc:
                chunks.append(acc)
                acc = []
        else:
            if acc:
                chunks.append(acc)
                acc = []
            chunks.append([frame])
    if acc:
        chunks.append(acc)
    return chunks
