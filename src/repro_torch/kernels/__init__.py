"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (K2, prefill) and ``decode_attention`` (K1).

Nothing here touches CUDA or ``nvcc`` at import; a kernel is built by
``build.py`` at its first launch (or by ``build.build()`` up front)."""
