"""The native (C++) extractor on the host: BGZF and BAM reading, the
pileup and the window tensorizer, compiled into a C-ABI shared library
and bound through ctypes. ``roko_tpu_torch/features/`` holds the Python
extractor that is its oracle."""
