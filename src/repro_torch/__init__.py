"""PyTorch/CUDA port of the parallel-combining reproduction.

``repro_torch`` mirrors ``repro`` module for module for the slice that has
been ported — the parallel-combining priority queue (``core``) and its
three heap kernels, hand-written in CUDA C++ for Hopper (``kernels``).  It
imports neither JAX nor the reference package ``repro``.  Entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""
