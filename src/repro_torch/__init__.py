"""PyTorch/CUDA port of the accelerator-codesign system.

The same predict -> measure -> refit loop as the JAX package ``repro``,
written for an NVIDIA H100: the eq.-18 sweep as torch broadcasts on the
card (:mod:`repro_torch.core`), the stencils as hand-written CUDA kernels
built with ``nvcc`` at first use (:mod:`repro_torch.kernels`), and the
timing harness and machine-parameter fit (:mod:`repro_torch.measure`).
Entry points that create tensors run on the card unless the caller passes
``device="cpu"``.
"""
