"""Proof layer: Nova-style folding over the LEM step circuit.

Exports what the JAX package's ``proof/__init__.py`` exports, except
its Spartan compression (``compress``, ``verify_compressed``,
``CompressedProof``), which waits for the port of Spartan.
"""

from .multiframe import MultiFrame, io_scalars  # noqa: F401
from .nova import (  # noqa: F401
    CommitmentKey, FoldingProof, PublicParams, R1CSShape, RecursiveSNARK,
    check_relaxed, check_strict, verify,
)
from .prover import NovaProver, public_params  # noqa: F401
