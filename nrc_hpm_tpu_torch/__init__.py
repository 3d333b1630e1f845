"""PyTorch + CUDA port of ``nrc_hpm_tpu`` for one NVIDIA H100.

Module names mirror the JAX package so each counterpart is easy to find.
This package imports ``torch`` and never ``jax``; the hand-written CUDA
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``ops/_build.py``).

Entry points that make tensors (``Volume.from_dense``, ``Camera``, the
lights, ``RingBuffer.create``, the cache's states, ``weights``) put them
on the card unless the caller passes ``device="cpu"``; everything
downstream follows the device of its inputs.
"""
