"""The token pipeline of the port (``repro.data``' twin)."""
from .pipeline import DataConfig, TokenPipeline, make_pipeline

__all__ = ["DataConfig", "TokenPipeline", "make_pipeline"]
