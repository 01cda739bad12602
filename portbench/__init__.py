"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once (``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``).  Cells, configurations,
traffic mixes and per-layer metrics are data: ``BENCHMARK.json`` names
them, and the harness finds each by its name under ``portbench/``
(``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``).  Nothing here imports
``jax`` or the JAX package ``repro``; the plain references under
``reference/`` import nothing of the port either.
"""
