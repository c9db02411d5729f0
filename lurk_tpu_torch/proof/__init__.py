"""Proof layer: Nova-style folding over the LEM step circuit, the
SuperNova cycle fold (the JAX package's default backend) and its
Spartan compression.

Exports what the JAX package's ``proof/__init__.py`` exports, and the
cycle fold's entry points (``SuperNovaCycleProver``,
``compress_sn_cycle``, ``verify_compressed_sn_cycle``).
"""

from .multiframe import MultiFrame, io_scalars  # noqa: F401
from .nova import (  # noqa: F401
    CommitmentKey, FoldingProof, PublicParams, R1CSShape, RecursiveSNARK,
    check_relaxed, check_strict, verify,
)
from .prover import NovaProver, public_params  # noqa: F401
from .prover_supernova_cycle import (  # noqa: F401
    CompressedSnCycleProof, SuperNovaCycleProver, compress_sn_cycle,
    verify_compressed_sn_cycle,
)
from .spartan import (  # noqa: F401
    CompressedProof, compress, verify_compressed,
)
from .supernova_cycle import SnCycleProof, SnCyclePublicParams  # noqa: F401
