"""SSD scan kernel (counterpart of ``repro.kernels.ssd_scan``)."""
from .grad import (SSDScanFn, SSDScanNormFn, scan, ssd_scan_bwd,
                   ssd_scan_bwd_plain, ssd_wide_bwd)
from .kernel import ssd_scan, ssd_scan_plain
from .ops import gla

__all__ = ["SSDScanFn", "SSDScanNormFn", "gla", "scan", "ssd_scan",
           "ssd_scan_bwd", "ssd_scan_bwd_plain", "ssd_scan_plain",
           "ssd_wide_bwd"]
