"""roko consensus polishing on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``roko_tpu``, which stays the reference it is
held against. This package imports neither JAX nor ``roko_tpu``. Entry
points run on CUDA unless the caller asks for the CPU. The recurrences
run in hand-written kernels: ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``
for ``kind="gru"``, ``csrc/lingru_fwd.cu`` and ``csrc/lingru_bwd.cu`` for
``kind="lingru"``. Feature extraction (``features/``, ``io/``,
``native/``, ``sim``) runs on the host and imports no torch.
"""
