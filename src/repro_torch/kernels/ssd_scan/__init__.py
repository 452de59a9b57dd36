"""SSD scan kernel (counterpart of ``repro.kernels.ssd_scan``)."""
from .kernel import ssd_scan, ssd_scan_plain
from .ops import gla

__all__ = ["gla", "ssd_scan", "ssd_scan_plain"]
