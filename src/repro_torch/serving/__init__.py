"""Serving — the async parallel-combining scheduler (``repro.serving``'
twin)."""
from .scheduler import (BatchRequest, PCScheduler, SerialScheduler)  # noqa: F401
