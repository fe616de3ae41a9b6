"""tandem_tpu_torch: the PyTorch / CUDA port of tandem_tpu for NVIDIA Hopper.

Module paths mirror ``tandem_tpu`` so every file has an obvious
counterpart. This package imports torch and numpy only; the JAX package is
the reference it is tested against (tests/test_torch_*.py), never a
dependency. Hand-written CUDA kernels live in ``csrc/`` and are built at
first use into ``_build/`` (ops/_build.py).
"""
