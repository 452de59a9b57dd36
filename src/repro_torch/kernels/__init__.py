"""Hand-written CUDA kernels of the port, with their plain torch versions.

Sources live in ``csrc/``; ``build`` compiles them with ``nvcc`` at first
use.  Each kernel package exposes the wrapper (launch counter included) and
the plain version it is held against.
"""
