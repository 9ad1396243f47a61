"""PyTorch/CUDA port of the ψ-score system (Power-ψ, Alg. 2 of the paper).

A package beside the JAX one with the same module layout (``graphs``,
``core``, ``kernels``, ``launch``). It imports torch, numpy and scipy only.
Entry points run on a CUDA card unless the caller passes ``device="cpu"``;
the hot loop runs through hand-written CUDA kernels (``kernels/csrc``),
built with nvcc at first use.
"""
__all__ = ["graphs", "core", "kernels", "launch", "convert", "device"]
