"""Public wrapper in the model layout (``[B, L, H, ...]``): ``slstm`` is
``kernel.slstm_scan`` (the CUDA kernel on CUDA tensors, the plain version
on the CPU).  gx: [B, L, H, 4 dh]; r: [H, dh, 4 dh]; carry (c, n, h, m),
each [B, H, dh] -> (ys [B, L, H, dh], carry')."""
from .kernel import slstm_scan

__all__ = ["slstm"]

slstm = slstm_scan
