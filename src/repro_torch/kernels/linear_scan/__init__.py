"""The recurrent families' linear scans: the rwkv6_scan and rglru_scan
kernels."""
from .ops import rglru_scan, rglru_scan_plain, rwkv6_scan, rwkv6_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "rwkv6_scan",
           "rwkv6_scan_plain"]
