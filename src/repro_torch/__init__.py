"""SCAR scheduler ported to PyTorch and CUDA (NVIDIA H100).

Counterpart of the JAX package ``repro``: same module layout and names,
torch tensors for batched math, hand-written CUDA kernels in place of the
Pallas ones (``repro_torch.kernels``).  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
