"""Fused RMSNorm: the norm before every block of the model zoo.

Port of ``repro.kernels.rmsnorm`` (the Pallas TPU kernel
``_rmsnorm_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_rmsnorm`.  :func:`cuda_rmsnorm` launches the hand-written ``sm_90a``
kernel of ``csrc/rmsnorm.cu`` (built at first use) on CUDA tensors and
raises on anything it does not take; the dispatch between it and the
plain version is :func:`repro_torch.kernels.ops.rmsnorm`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the hand kernel (one per wrapper call on CUDA tensors); the
# serve engine launches from several threads, so the count takes a lock.
# chip_smoke.py zeroes it before driving a path.
launch_count = 0
_COUNT_LOCK = threading.Lock()


def reset_count() -> None:
    global launch_count
    with _COUNT_LOCK:
        launch_count = 0


def _counted() -> None:
    global launch_count
    with _COUNT_LOCK:
        launch_count += 1


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
            ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """The hand kernel: x (..., D) and scale (D,) CUDA tensors of float32
    or bfloat16 (each its own) → a contiguous tensor of x's shape and
    dtype."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("cuda_rmsnorm: x and scale must lie on the same "
                         "CUDA device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"cuda_rmsnorm: want float32 or bfloat16, got "
                        f"{x.dtype}, {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"cuda_rmsnorm: want x (..., D) and scale (D,), "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # a view of x as (rows, D) where the strides allow it, else a copy
    x2 = x.reshape(rows, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    scale = scale.contiguous()
    # a single row's stride is arbitrary in PyTorch; the kernel reads D
    row_stride = x2.stride(0) if rows > 1 else d
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().rmsnorm_launch(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), row_stride,
        rows, d, float(eps), _DTYPES[x.dtype], _DTYPES[scale.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: cudaError {err}")
    _counted()
    return out
