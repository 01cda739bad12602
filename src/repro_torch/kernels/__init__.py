"""Hand-written Hopper kernels of the port and their plain versions.

One package per TPU kernel of the reference (``src/repro/kernels``):
``heap_kmin`` (phase 1), ``heap_sift`` (phase 3) and ``heap_insert``
(phase 4) of the priority queue, ``label_prop`` (the dynamic graph's and
the union-find's label fixpoint), ``sorted_merge`` (the ordered map's
and the counting sketch's shard rebuild), ``flash_attention`` (the
dense decoder's full-sequence attention) and ``linear_scan`` (the
recurrent families' ``rwkv6_scan`` and ``rglru_scan``, each with a
backward kernel for training).  The CUDA sources live in
``csrc/`` and are built by ``_build`` at first use on the card; nothing
here imports ``triton`` or compiles at import time.
"""
