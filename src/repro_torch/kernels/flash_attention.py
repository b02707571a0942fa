"""Flash attention (causal / sliding-window, GQA): the model zoo's
full-sequence attention kernel.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_attention`.  :func:`cuda_flash_attention` launches the hand-written
``sm_90a`` kernel of ``csrc/flash_attention.cu`` (built at first use) on
CUDA tensors and raises on anything it does not take; the dispatch
between it and the plain version is :func:`repro_torch.kernels.ops.
flash_attention`.

The source has two bodies: f32 runs on the CUDA cores (``CORE``), bf16
on the tensor cores (``TC``: ``mma.sync`` fed by a ``cp.async`` ring),
which needs 16-byte aligned rows; a bf16 view whose rows are not
16-byte aligned takes the CUDA-core body, which reads elements.
:func:`tc_route` makes the choice.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "flash_attention"
HEAD_DIMS = (64, 112, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CORE, TC = 0, 1          # the launcher's routes: CUDA cores, tensor cores

# launches of the hand kernel (one per wrapper call on CUDA tensors), and
# those of them that took the tensor-core route; the serve engine
# launches from several threads, so the counts take a lock.
# chip_smoke.py zeroes them before driving the serve path.
launch_count = 0
tc_launch_count = 0
_COUNT_LOCK = threading.Lock()


def reset_count() -> None:
    global launch_count, tc_launch_count
    with _COUNT_LOCK:
        launch_count = tc_launch_count = 0


def _counted(route: int) -> None:
    global launch_count, tc_launch_count
    with _COUNT_LOCK:
        launch_count += 1
        tc_launch_count += route == TC


def tc_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The body that q, k and v (B,H,S,hd) / (B,KV,S,hd) take: ``CORE``
    for float32, ``TC`` for bfloat16.  The tensor-core body copies rows
    in 16-byte chunks, so a bfloat16 view takes it only where each base
    address is a multiple of 16 bytes and each (b, h, s) stride of an
    axis longer than one a multiple of 8 elements; any other bfloat16
    view takes ``CORE``, the CUDA-core body, which reads elements (as
    ``moe_gemm`` does off its 16-byte width).  Reads dtype, shape,
    strides and addresses only."""
    if q.dtype != torch.bfloat16:
        return CORE
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(
                t.shape[i] > 1 and t.stride(i) % 8 for i in range(3)):
            return CORE
    return TC


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         _route: int | None = None) -> torch.Tensor:
    """The hand kernel: q (B,H,S,hd), k/v (B,KV,S,hd) CUDA tensors of one
    dtype (f32 or bf16), hd 64, 112, 128 or 192, any (b, h, s) strides
    with a contiguous hd axis (the body by :func:`tc_route`) → (B,H,S,hd)
    in ``q``'s layout.  ``_route`` forces a body (``CORE`` runs bf16 on
    the CUDA cores); only ``chip_smoke.py`` passes it, to time and check
    the earlier bf16 body."""
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
    route = tc_route(q, k, v)
    if _route is not None:
        if _route not in (CORE, TC) or (_route == TC and route != TC):
            raise ValueError(f"cuda_flash_attention: route {_route} does not "
                             f"take this {q.dtype} input (dtype or "
                             f"alignment)")
        route = _route
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # an axis of length one is only ever read at index 0: its stride is
    # passed as 0
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) if t.shape[i] > 1 else 0
                                      for t in (q, k, v, out)
                                      for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, s, hd, h // kv, int(causal), int(window), hd ** -0.5,
        _DTYPES[q.dtype], route, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    _counted(route)
    return out
