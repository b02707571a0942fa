"""Flash decode: single-token attention over a KV cache with a valid
prefix per batch row.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_decode_attention`.  :func:`cuda_decode_attention` launches the
hand-written ``sm_90a`` kernel of ``csrc/decode_attention.cu`` (built at
first use) on CUDA tensors and raises on anything it does not take; the
dispatch between it and the plain version is :func:`repro_torch.kernels.
ops.decode_attention`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "decode_attention"
HEAD_DIMS = (64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the hand kernel (one per wrapper call on CUDA tensors),
# counted under a lock; chip_smoke.py zeroes it before the decode path
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
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor, dims) -> bool:
    """Base pointer and the given strides on 16-byte boundaries (the
    kernel reads cache rows with 16-byte loads)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * size) % 16 == 0 for i in dims)


def cuda_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The hand kernel: q (B,H,hd), k/v (B,KV,W,hd) — any strides with a
    contiguous hd axis, e.g. a transposed view of a (B,W,KV,hd) cache —
    and int32 ``lengths`` (B,) on one CUDA device → (B,H,hd)."""
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, lengths)):
        raise ValueError("cuda_decode_attention: q, k, v and lengths must "
                         "lie on the same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cuda_decode_attention: want one dtype of float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"cuda_decode_attention: lengths must be int32, "
                        f"got {lengths.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"cuda_decode_attention: want q (B,H,hd) and k/v "
                         f"(B,KV,W,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    kv, w = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kv < 1 or h % kv \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"cuda_decode_attention: k/v {tuple(k.shape)} or "
                         f"lengths {tuple(lengths.shape)} do not match q "
                         f"{tuple(q.shape)} (H % KV must be 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"cuda_decode_attention: hd={hd} not in "
                         f"{HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("cuda_decode_attention: the hd axis must be "
                         "contiguous")
    if not (_aligned(k, range(3)) and _aligned(v, range(3))):
        raise ValueError("cuda_decode_attention: k/v base pointers and "
                         "strides must be multiples of 16 bytes")
    lengths = lengths.contiguous()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if w == 0:
        return out.zero_()
    strides = (ctypes.c_int64 * 10)(q.stride(0), q.stride(1),
                                    *(t.stride(i) for t in (k, v)
                                      for i in range(3)),
                                    out.stride(0), out.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), strides, b, h, w, hd, h // kv, hd ** -0.5,
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{err}")
    _counted()
    return out
