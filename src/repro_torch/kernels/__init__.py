"""Hand-written Hopper kernels of the port and their plain versions.

One package per TPU kernel of the reference (``src/repro/kernels``):
``heap_kmin`` (phase 1), ``heap_sift`` (phase 3) and ``heap_insert``
(phase 4).  The CUDA sources live in ``csrc/`` and are built by
``_build`` at first use on the card; nothing here imports ``triton`` or
compiles at import time.
"""
