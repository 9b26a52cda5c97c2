"""PyTorch/CUDA port of the ``repro`` serving stack (NVIDIA H100 target).

Module paths mirror the JAX package in ``src/repro``, which stays the
reference: every ported module is tested against its counterpart there.
This package imports ``torch``, numpy and the standard library only.
"""
