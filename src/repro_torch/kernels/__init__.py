"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel module holds the wrapper that launches its kernel (sources in
``csrc/``, built by ``_build.py``) beside the plain version the CPU tests
use; ``ops.py`` dispatches between them.
"""
