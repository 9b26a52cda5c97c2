"""PyTorch/CUDA port of the ``repro`` package — the serving stack and the
paper's NN library with its Keras2DML analogue (NVIDIA H100 target).

Module paths mirror the JAX package in ``src/repro``, which stays the
reference: every ported module is tested against its counterpart there.
This package imports ``torch``, numpy and the standard library only.
"""
