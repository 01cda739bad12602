"""Launch code of the port (``repro.launch``' twin): the serving entry point —
the decode and structure executors, ``run_serving`` and its CLI
(``python -m repro_torch.launch.serve``) — and the training entry point —
the step factories (``steps``) and the trainer with its CLI
(``python -m repro_torch.launch.train``)."""
