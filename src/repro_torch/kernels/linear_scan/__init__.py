"""The recurrent families' linear scans: the rwkv6_scan and rglru_scan
kernels and their backward kernels."""
from .ops import (rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain,
                  rglru_scan_plain, rwkv6_scan, rwkv6_scan_bwd,
                  rwkv6_scan_bwd_plain, rwkv6_scan_plain)

__all__ = ["rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "rglru_scan_plain", "rwkv6_scan", "rwkv6_scan_bwd",
           "rwkv6_scan_bwd_plain", "rwkv6_scan_plain"]
