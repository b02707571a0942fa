"""Fused RMSNorm: the norm before every block of the model zoo.

Port of ``repro.kernels.rmsnorm`` (the Pallas TPU kernel
``_rmsnorm_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_rmsnorm`.  :func:`cuda_rmsnorm` launches the hand-written ``sm_90a``
kernel of ``csrc/rmsnorm.cu`` (built at first use) on CUDA tensors and
raises on anything it does not take; the dispatch between it and the
plain version is :func:`repro_torch.kernels.ops.rmsnorm`.

The source has two bodies.  ``REGS`` keeps a row in the registers of a
row group of 32·k threads (each thread ``vpt`` 16-byte vectors), issues
every load before the first use and writes with 16-byte stores: every
view on the 16-byte width takes it, f32 and bf16.  ``PREVIOUS``, the
body before it (a block of 128 threads a row, two passes), takes the
views off that width (a base address or row stride off it, D not a
multiple of the 16-byte vector) and rows wider than the register plan
holds.  :func:`norm_plan` makes the choice and sizes the launch; the C
side checks the plan and refuses one it does not take.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PREVIOUS, REGS = 0, 1     # the launcher's routes
VEC_BYTES = 16            # a vector load or store of the REGS body
MANY_ROWS = 256           # from here, rows of ≤ 256 vectors take a warp each
ROWS_PER_BLOCK = 4        # rows a block in that many-row layout
# the (vpt, k) plans csrc/rmsnorm.cu builds REGS for, by x's dtype
PLANS = {torch.bfloat16: {(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (2, 4),
                          (2, 8), (2, 16), (2, 32), (3, 32)}}
PLANS[torch.float32] = PLANS[torch.bfloat16] | {(4, 32), (5, 32)}
# The register budget of a REGS thread: its row data (each x vector 4
# registers, the scale beside it at most 8: f32 beside bf16) plus
# REG_OVERHEAD for addresses, the sum and the loop must fit what the SM's
# 65,536 registers give each of the block's threads (at most 255).
REG_OVERHEAD = 24
PREVIOUS_PLAN = (PREVIOUS, 0, 4, 1, 128)

# launches of the hand kernel (one per wrapper call on CUDA tensors), and
# those of them that took the REGS body; the serve engine launches from
# several threads, so the counts take a lock.  chip_smoke.py zeroes them
# before driving a path.
launch_count = 0
reg_launch_count = 0
_COUNT_LOCK = threading.Lock()


def reset_count() -> None:
    global launch_count, reg_launch_count
    with _COUNT_LOCK:
        launch_count = reg_launch_count = 0


def _counted(route: int) -> None:
    global launch_count, reg_launch_count
    with _COUNT_LOCK:
        launch_count += 1
        reg_launch_count += route == REGS


def row_registers(vpt: int, dtype: torch.dtype) -> int:
    """The 32-bit registers a REGS thread holds its row data in: ``vpt``
    vectors of x (4 each) and the scale beside them, counted at its
    widest (8 for f32 beside bf16 x, 4 beside f32 x)."""
    return vpt * (4 + (8 if dtype == torch.bfloat16 else 4))


def register_cap(threads: int) -> int:
    """Registers a thread may use at ``threads`` a block, all resident."""
    return min(255, 65536 // threads)


def norm_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool
              ) -> tuple[int, int, int, int, int]:
    """``(route, vpt, warps_per_row, rows_per_block, threads)`` for
    ``rows`` rows of ``d`` elements of ``dtype`` (float32 or bfloat16);
    ``aligned``: x's and scale's base addresses and x's row stride are on
    the 16-byte width.  A pure function of its arguments.

    ``REGS`` where the view is aligned and ``d`` a multiple of the 16-byte
    vector (8 bf16, 4 f32).  Many rows (≥ ``MANY_ROWS``) of at most 256
    vectors take a warp a row (k = 1), ``vpt`` the power of two that
    covers the row, ``ROWS_PER_BLOCK`` rows a block; otherwise a block is
    one row group of k warps (a power of two), the fewest that hold the
    row in ≤ 2 vectors a thread, or 32 warps and as many vectors as the
    register budget allows.  Anything else takes ``PREVIOUS`` (a block of
    128 threads a row)."""
    vec = VEC_BYTES // (2 if dtype == torch.bfloat16 else 4)
    if not aligned or d < 1 or d % vec:
        return PREVIOUS_PLAN
    nvec = d // vec
    if rows >= MANY_ROWS and nvec <= 8 * 32:
        vpt = 1 << (-(-nvec // 32) - 1).bit_length()
        return (REGS, vpt, 1, ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK)
    k = 1
    while k < 32 and 64 * k < nvec:
        k *= 2
    vpt = -(-nvec // (32 * k))
    if row_registers(vpt, dtype) + REG_OVERHEAD > register_cap(32 * k):
        return PREVIOUS_PLAN
    return (REGS, vpt, k, 1, 32 * k)


def view_plan(x: torch.Tensor, scale: torch.Tensor
              ) -> tuple[int, int, int, int, int]:
    """:func:`norm_plan` for x (..., D) and scale (D,) as
    :func:`cuda_rmsnorm` hands them to the kernel: x as (rows, D) rows
    (a copy where the strides do not allow a view), scale contiguous.
    Reads dtype, shape, strides and addresses only."""
    return _plan(*_rows_view(x, scale))


def _rows_view(x: torch.Tensor, scale: torch.Tensor):
    """(x as (rows, D) with a contiguous D axis, scale contiguous, the row
    stride in elements)."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    # a view of x as (rows, D) where the strides allow it, else a copy
    x2 = x.reshape(rows, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    # a single row's stride is arbitrary in PyTorch; the kernel reads D
    row_stride = x2.stride(0) if rows > 1 else d
    return x2, scale.contiguous(), row_stride


def _plan(x2: torch.Tensor, scale: torch.Tensor, row_stride: int):
    rows, d = x2.shape
    aligned = (x2.data_ptr() % VEC_BYTES == 0
               and scale.data_ptr() % VEC_BYTES == 0
               and (row_stride * x2.element_size()) % VEC_BYTES == 0)
    return norm_plan(rows, d, x2.dtype, aligned)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
            ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5, *, _route: int | None = None
                 ) -> torch.Tensor:
    """The hand kernel: x (..., D) and scale (D,) CUDA tensors of float32
    or bfloat16 (each its own) → a contiguous tensor of x's shape and
    dtype; the body and launch by :func:`view_plan`.  ``_route=PREVIOUS``
    forces the earlier body; only ``chip_smoke.py`` passes it, to time
    and check that body beside the new one."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("cuda_rmsnorm: x and scale must lie on the same "
                         "CUDA device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"cuda_rmsnorm: want float32 or bfloat16, got "
                        f"{x.dtype}, {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"cuda_rmsnorm: want x (..., D) and scale (D,), "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x2, scale, row_stride = _rows_view(x, scale)
    plan = _plan(x2, scale, row_stride)
    if _route is not None:
        if _route not in (PREVIOUS, REGS) or (_route == REGS
                                              and plan[0] != REGS):
            raise ValueError(f"cuda_rmsnorm: route {_route} does not take "
                             f"this view (alignment, D or width)")
        if _route == PREVIOUS:
            plan = PREVIOUS_PLAN
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().rmsnorm_launch(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), row_stride,
        x2.shape[0], x2.shape[1], float(eps), _DTYPES[x.dtype],
        _DTYPES[scale.dtype], *plan, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: cudaError {err}")
    _counted(plan[0])
    return out
