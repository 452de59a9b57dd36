"""sLSTM recurrence kernel (no counterpart in ``repro.kernels``: the
reference runs ``_slstm_cell`` under ``lax.scan``)."""
from .grad import SLSTMScanFn, scan, slstm_scan_bwd, slstm_scan_bwd_plain
from .kernel import slstm_scan, slstm_scan_plain
from .ops import slstm

__all__ = ["SLSTMScanFn", "scan", "slstm", "slstm_scan", "slstm_scan_bwd",
           "slstm_scan_bwd_plain", "slstm_scan_plain"]
