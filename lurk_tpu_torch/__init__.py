"""lurk_tpu_torch: Lurk on PyTorch and CUDA (NVIDIA Hopper).

The port of ``lurk_tpu`` to one H100, slice by slice along the main path
(ROADMAP.md). This slice: reader -> content-addressed store -> LEM
evaluation -> batched Poseidon hydration, whose batches run through the
hand-written CUDA kernel in ``csrc/poseidon.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises. Kernels are compiled from
``csrc/`` at first use (:mod:`lurk_tpu_torch.native`), never on import.
"""
