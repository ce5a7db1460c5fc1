"""PyTorch/CUDA port of the Funky reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``models``, ``kernels``, ``core``, ``serve``, ``train``) and
imports nothing from it.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; the attention kernels are hand-written CUDA
C++ for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
"""
