"""repro_torch — the PyTorch/CUDA port of the LLCySA Accumulo pipeline
reproduction, for one NVIDIA H100.

The JAX package ``repro`` beside it is the reference. This package
imports neither ``jax`` nor anything of ``repro``: it keeps its own
copies of the host-side numpy modules. Its device path runs on the card
unless a caller asks for ``device="cpu"``; on CPU tensors every kernel
wrapper runs the kernel's plain PyTorch version.
"""
__version__ = "0.1.0"
