"""PyTorch/CUDA port of the parallel-combining reproduction.

``repro_torch`` mirrors ``repro`` module for module for the slices that
have been ported — the parallel-combining priority queue, the dynamic
connectivity graph, the union-find, the ordered map and the counting
sketch (``core``), the dense decoder model stack (``models``,
``configs``, and the decode executor in ``launch``), and their six
kernels, hand-written in CUDA C++ for Hopper (``kernels``).  It imports
neither JAX nor the reference package ``repro``.  Entry points run on the
GPU unless the caller passes ``device="cpu"``.
"""
