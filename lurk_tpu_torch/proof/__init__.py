"""Proof layer: Nova-style folding over the LEM step circuit, the
proving backends the JAX package's CLI dispatches to, and their Spartan
compression.

Exports what the JAX package's ``proof/__init__.py`` exports, and the
entry points of each backend: the SuperNova cycle, the default
(``SuperNovaCycleProver``, ``compress_sn_cycle``,
``verify_compressed_sn_cycle``); the Nova cycle (``CycleNovaProver``,
``compress_cycle``, ``verify_compressed_cycle``); and NIVC
(``SuperNovaProver``, ``compress_nivc``, ``verify_compressed_nivc``,
``verify_nivc``: the functions ``compress``, ``verify_compressed`` and
``verify`` of :mod:`.supernova`, renamed here beside Nova's).
"""

from .multiframe import MultiFrame, io_scalars  # noqa: F401
from .nova import (  # noqa: F401
    CommitmentKey, FoldingProof, PublicParams, R1CSShape, RecursiveSNARK,
    check_relaxed, check_strict, verify,
)
from .nova_cycle import CycleProof, CyclePublicParams  # noqa: F401
from .prover import NovaProver, public_params  # noqa: F401
from .prover_cycle import (  # noqa: F401
    CompressedCycleProof, CycleNovaProver, compress_cycle,
    verify_compressed_cycle,
)
from .prover_supernova_cycle import (  # noqa: F401
    CompressedSnCycleProof, SuperNovaCycleProver, compress_sn_cycle,
    verify_compressed_sn_cycle,
)
from .spartan import (  # noqa: F401
    CompressedProof, compress, verify_compressed,
)
from .supernova import (  # noqa: F401
    CompressedNivcProof, NivcProof, SuperNovaProver, SuperNovaPublicParams,
    compress as compress_nivc, verify as verify_nivc,
    verify_compressed as verify_compressed_nivc,
)
from .supernova_cycle import SnCycleProof, SnCyclePublicParams  # noqa: F401
