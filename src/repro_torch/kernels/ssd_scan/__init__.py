"""SSD scan kernel (counterpart of ``repro.kernels.ssd_scan``)."""
from .grad import SSDScanFn, scan, ssd_scan_bwd, ssd_scan_bwd_plain
from .kernel import ssd_scan, ssd_scan_plain
from .ops import gla

__all__ = ["SSDScanFn", "gla", "scan", "ssd_scan", "ssd_scan_bwd",
           "ssd_scan_bwd_plain", "ssd_scan_plain"]
