"""Ragged grouped GEMM: the MoE family's expert products.

Port of ``repro.kernels.moe_gemm`` (the Pallas TPU kernel
``_moe_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_moe_gemm` on the rows that some expert owns.  :func:`cuda_moe_gemm`
launches the hand-written ``sm_90a`` kernel of ``csrc/moe_gemm.cu``
(built at first use) on CUDA tensors and raises on anything it does not
take; the dispatch between it and the plain version is
:func:`repro_torch.kernels.ops.moe_gemm`.

Unlike the Pallas version, any T is taken (no ``T % block_t == 0``).
Rows before ``offsets[0]`` or from ``offsets[E]`` on come out as zero, as
``_moe_kernel`` gives them; ``ref_moe_gemm`` clips them to expert 0 or
E−1 instead, so the two are compared where ``offsets[0] == 0`` and
``offsets[E] == T`` (always so on the model's path).  ``offsets`` are
read on the device, so the caller keeps them nondecreasing; values
outside [0, T] are clipped there.

The source has two bodies: f32 runs on the CUDA cores (``CORE``), bf16
with D and F multiples of 8 on the tensor cores (``TC``: ``mma.sync``
over a ``cp.async`` weight ring); :func:`tc_route` makes the choice and
:func:`row_tiles` sizes the tensor-core body's row tile.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "moe_gemm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CORE, TC = 0, 1          # the launcher's routes: CUDA cores, tensor cores
ROW_TILES = (1, 2, 4, 8)  # m16 tiles a tensor-core row tile may hold

# launches of the hand kernel (one per wrapper call on CUDA tensors), and
# those of them that took the tensor-core route, counted under a lock;
# chip_smoke.py zeroes them before driving a path
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


def tc_route(x_sorted: torch.Tensor, w: torch.Tensor) -> int:
    """The body that x (T, D) and w (E, D, F) take: ``TC`` for bfloat16
    with D and F multiples of 8 and both storage offsets multiples of 8
    elements (16-byte rows for ``cp.async``), else ``CORE`` (float32, or
    the bf16 shapes off the vector width).  Reads dtype, shape and
    storage offsets and w's expert stride only; the wrapper makes x
    contiguous first, and w when its experts' blocks are not whole."""
    if x_sorted.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return CORE
    if w.shape[1] % 8 or w.shape[2] % 8:
        return CORE
    if x_sorted.storage_offset() % 8 or w.storage_offset() % 8 \
            or w.stride(0) % 8:
        return CORE
    return TC


def row_tiles(t: int, e: int) -> int:
    """The tensor-core body's row tile in m16 tiles: the mean rows an
    expert, ⌈T/E/16⌉, rounded up to 1, 2, 4 or 8 (1 at serve and decode,
    8 at qwen3-moe's prefill, whose 81 rows an expert then take one
    pass).  An expert with more rows loops over tiles."""
    need = -(-t // (16 * e))
    return next((mt for mt in ROW_TILES if need <= mt), ROW_TILES[-1])


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.moe_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_moe_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
                  offsets: torch.Tensor, *,
                  _route: int | None = None) -> torch.Tensor:
    """The hand kernel: x_sorted (T, D) and w (E, D, F) CUDA tensors of one
    type (float32 or bfloat16), offsets (E+1,) int32 on the same card →
    (T, F) in x's type.  w may be a view whose experts lie apart (a split
    of a split-expert weight, ``w.view(E, s, D, F)[:, j]``): the kernel
    takes its expert stride, and nothing is copied, as long as each
    expert's (D, F) block is contiguous.  ``_route`` forces a body
    (``CORE`` runs bf16 on the CUDA cores); only ``chip_smoke.py`` passes
    it, to time and check the earlier bf16 body."""
    if x_sorted.device.type != "cuda" or w.device != x_sorted.device \
            or offsets.device != x_sorted.device:
        raise ValueError("cuda_moe_gemm: x_sorted, w and offsets must lie on "
                         "the same CUDA device")
    if x_sorted.dtype not in _DTYPES or w.dtype != x_sorted.dtype:
        raise TypeError(f"cuda_moe_gemm: want x and w both float32 or both "
                        f"bfloat16, got {x_sorted.dtype}, {w.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"cuda_moe_gemm: want int32 offsets, got "
                        f"{offsets.dtype}")
    if x_sorted.dim() != 2 or w.dim() != 3 \
            or w.shape[1] != x_sorted.shape[1] \
            or offsets.shape != (w.shape[0] + 1,) or w.shape[0] < 1:
        raise ValueError(f"cuda_moe_gemm: want x (T, D), w (E, D, F) and "
                         f"offsets (E+1,), got {tuple(x_sorted.shape)}, "
                         f"{tuple(w.shape)}, {tuple(offsets.shape)}")
    t, d = x_sorted.shape
    e, _, f = w.shape
    if max(t, d, f, e + 1) >= 2 ** 31 or e >= 65535:
        raise ValueError(f"cuda_moe_gemm: shape {(t, d, f, e)} is too large")
    out = torch.empty((t, f), dtype=x_sorted.dtype, device=x_sorted.device)
    if out.numel() == 0:
        return out
    x_sorted = x_sorted.contiguous()
    if w.stride(2) != 1 or w.stride(1) != f or w.stride(0) < d * f:
        w = w.contiguous()
    offsets = offsets.contiguous()
    route = tc_route(x_sorted, w)
    if _route is not None:
        if _route not in (CORE, TC) or (_route == TC and route != TC):
            raise ValueError(f"cuda_moe_gemm: route {_route} does not take "
                             f"{x_sorted.dtype} x, w {tuple(w.shape)}")
        route = _route
    if route == TC and any(p.data_ptr() % 16 for p in (x_sorted, w, out)):
        raise ValueError("cuda_moe_gemm: a bf16 base address is not "
                         "16-byte aligned")
    stream = torch.cuda.current_stream(x_sorted.device).cuda_stream
    err = _lib().moe_gemm_launch(
        x_sorted.data_ptr(), w.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), t, d, f, e, w.stride(0), _DTYPES[x_sorted.dtype],
        route,
        row_tiles(t, e), stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: cudaError {err}")
    _counted(route)
    return out
