"""Flash attention (causal / sliding-window, GQA): the model zoo's
full-sequence attention kernel.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_attention`.  :func:`cuda_flash_attention` launches the hand-written
``sm_90a`` kernel of ``csrc/flash_attention.cu`` (built at first use) on
CUDA tensors and raises on anything it does not take; the dispatch
between it and the plain version is :func:`repro_torch.kernels.ops.
flash_attention`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "flash_attention"
HEAD_DIMS = (64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the hand kernel (one per wrapper call on CUDA tensors); the
# serve engine launches from several threads, so the count takes a lock.
# chip_smoke.py zeroes it before driving the serve path.
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
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """The hand kernel: q (B,H,S,hd), k/v (B,KV,S,hd) CUDA tensors of one
    dtype (f32 or bf16), hd 64, 112 or 128, any (b, h, s) strides with a
    contiguous hd axis → (B,H,S,hd) in ``q``'s layout."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("cuda_flash_attention: q, k and v must lie on the "
                         "same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cuda_flash_attention: want one dtype of float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"cuda_flash_attention: want q (B,H,S,hd) and k/v "
                         f"(B,KV,S,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd \
            or kv < 1 or h % kv:
        raise ValueError(f"cuda_flash_attention: k/v {tuple(k.shape)} do "
                         f"not match q {tuple(q.shape)} (H % KV must be 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"cuda_flash_attention: hd={hd} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"cuda_flash_attention: window={window} < 0")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("cuda_flash_attention: the hd axis must be "
                         "contiguous")
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out)
                                      for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, s, hd, h // kv, int(causal), int(window), hd ** -0.5,
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    _counted()
    return out
