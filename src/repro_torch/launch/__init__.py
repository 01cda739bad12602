"""Launch code of the port (``repro.launch``' twin): the serving entry point —
the decode and structure executors, ``run_serving`` and its CLI
(``python -m repro_torch.launch.serve``)."""
