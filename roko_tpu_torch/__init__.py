"""roko consensus polishing on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``roko_tpu``, which stays the reference it is
held against. This package imports neither JAX nor ``roko_tpu``. Entry
points run on CUDA unless the caller asks for the CPU; the GRU
recurrence runs in the hand-written kernel ``csrc/gru_fwd.cu``.
"""
