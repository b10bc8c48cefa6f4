"""Training of the port: the data stream, the guard, checkpoints and the
train loop (counterparts of ``roko_tpu/datapipe`` and
``roko_tpu/training``)."""
