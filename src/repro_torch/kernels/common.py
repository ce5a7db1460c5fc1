"""Checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.launch.mesh import is_dtensor

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version); raises on a mix of devices or a device without a
    kernel (e.g. ``meta``), and on a DTensor: on a mesh a kernel runs in
    ``shard_map`` on each rank's local shards."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError("kernel inputs must be local tensors, not DTensors "
                        "(run the kernel in launch.mesh.shard_map)")
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    devs = {t.device for t in tensors}
    if types != {"cuda"} or len(devs) != 1:
        raise ValueError(f"kernel inputs must all be on one CUDA device "
                         f"(or all on the CPU); got {sorted(map(str, devs))}")
    return False


def check_operands(name: str, tensors: dict, dtype: torch.dtype) -> int:
    """Dtype / contiguity / alignment checks; returns the dtype code."""
    if str(dtype).removeprefix("torch.") not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{rc}")
