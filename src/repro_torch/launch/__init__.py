"""Launch code of the port (``repro.launch``' twin): so far the decode
executor of the serving path."""
