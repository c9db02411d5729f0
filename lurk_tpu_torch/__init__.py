"""lurk_tpu_torch: Lurk on PyTorch and CUDA (NVIDIA Hopper).

The port of ``lurk_tpu`` to one H100, slice by slice along the main path
(ROADMAP.md): reader -> content-addressed store -> LEM evaluation ->
batched Poseidon hydration (the CUDA kernel ``csrc/poseidon.cu``; the
sharded prover layer through ``csrc/poseidon_dense.cu``) -> the step
circuit's witness-only synthesis per folding step
(:mod:`.proof.multiframe`, host C++ Poseidon trace) -> Pedersen
commitments of each step's witness through the MSM kernel
``csrc/msm.cu``. The headline benchmark, :mod:`.bench`, also runs the
folded-span Poseidon kernel ``csrc/poseidon_folded.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises. Kernels are compiled from
``csrc/`` at first use (:mod:`lurk_tpu_torch.native`), never on import.
"""
