"""PyTorch + CUDA port of ``nrc_hpm_tpu`` for one NVIDIA H100.

Module names mirror the JAX package so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``; the hand-written CUDA
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``ops/_build.py``).
"""
