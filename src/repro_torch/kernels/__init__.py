"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (K2, prefill), ``decode_attention`` (K1),
``ssd_scan`` (K3, Mamba2 prefill) and ``rglru_scan`` (K4, RG-LRU prefill).

Nothing here touches CUDA or ``nvcc`` at import; a kernel is built by
``build.py`` at its first launch (or by ``build.build()`` up front)."""
