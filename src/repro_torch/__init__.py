"""PyTorch/CUDA port of the parallel-combining reproduction.

``repro_torch`` mirrors ``repro`` module for module for the slices that
have been ported — the parallel-combining priority queue, the dynamic
connectivity graph, the union-find, the ordered map and the counting
sketch (``core``), the dense decoder model stack (``models``,
``configs``), the serving layer (the parallel-combining scheduler over
the sharded deadline PQ in ``serving``; the decode and structure
executors, ``run_serving`` and the CLI in ``launch``), the training path
(the token pipeline in ``data``, AdamW and the int8 quantizer in
``optim``, checkpoints in ``checkpoint``, the step factories and the
trainer in ``launch``), and their eight kernels with the backward
kernels of the two scans, hand-written in CUDA C++ for Hopper
(``kernels``).  It imports
neither JAX nor the reference package ``repro``.  Entry points run on the
GPU unless the caller passes ``device="cpu"``.
"""
