"""Selective state-space scan: the Mamba2 / SSD core of the hybrid family.

Port of ``repro.kernels.ssm_scan`` (the Pallas TPU kernel
``_ssm_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_selective_scan`.  :func:`cuda_ssm_scan` launches the hand-written
``sm_90a`` kernel of ``csrc/ssm_scan.cu`` (built at first use) on CUDA
tensors and raises on anything it does not take; the dispatch between it
and the plain version is :func:`repro_torch.kernels.ops.ssm_scan`.

The source has two bodies: the sequential one on the CUDA cores
(``SEQ``), which f32 takes (the f32 goldens need it) and which was the
bf16 body before the chunked one, and the chunked (SSD) one on the
tensor cores (``CHUNKED``), which bf16 takes where x, B and C lie on the
16-byte width (the model's views do), since it copies their rows in
16-byte ``cp.async`` chunks; bf16 views off that width take ``SEQ``.
:func:`scan_route` makes the choice; the chunked body's arithmetic,
rounding points included, is emulated by
:func:`repro_torch.kernels.ref.ref_chunked_scan`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "ssm_scan"
MAX_P = 128
MAX_N = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SEQ, CHUNKED = 0, 1                      # the launcher's routes

# launches of the hand kernel (one per wrapper call on CUDA tensors), and
# those of them that took the chunked tensor-core body, counted under a
# lock; chip_smoke.py zeroes them before driving a path
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
        tc_launch_count += route != SEQ


def scan_route(x: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor) -> int:
    """The body that x (*L,S,P) and bmat/cmat (*L,S,N) take: ``CHUNKED``
    for bfloat16 where it can copy their rows in 16-byte chunks (P and N
    multiples of 8, each base address a multiple of 16 bytes, and each
    stride over L and S of an axis longer than one a multiple of 8
    elements; any S, P, N ≤ 128), ``SEQ`` for float32 and for bfloat16
    elsewhere.  y, made by :func:`empty_in_layout`, then lies on the
    16-byte width too.  Reads dtype, shape, strides and addresses only."""
    if x.dtype != torch.bfloat16:
        return SEQ
    for t in (x, bmat, cmat):
        if t.shape[-1] % 8 or t.data_ptr() % 16 or any(
                t.shape[i] > 1 and t.stride(i) % 8
                for i in range(t.dim() - 1)):
            return SEQ
    return CHUNKED


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def empty_in_layout(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``x``'s shape and dtype whose memory
    order follows ``x``'s strides (outermost first), with the last axis
    innermost (contiguous) whatever its stride in ``x``: for a transposed
    (B,H,S,P) view of a (B,S,H,P) buffer, a (B,H,S,P) view of a fresh
    (B,S,H,P) buffer."""
    last = x.dim() - 1
    order = sorted(range(x.dim()),
                   key=lambda i: (i == last, -x.stride(i), i))
    buf = torch.empty([x.shape[i] for i in order], dtype=x.dtype,
                      device=x.device)
    return buf.permute([order.index(i) for i in range(x.dim())])


def cuda_ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bmat: torch.Tensor, cmat: torch.Tensor, *,
                  _route: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hand kernel on CUDA tensors: x (*L,S,P), dt (*L,S), a (*L),
    bmat/cmat (*L,S,N) with L = (G,) or (B, H) — any strides over L and S
    (zero ones included: heads that share B/C, a broadcast decay) with a
    contiguous last axis for x, bmat and cmat.  x, dt, bmat and cmat are
    one dtype (float32 or bfloat16), a is float32; P, N ≤ 128.  Returns
    (y (*L,S,P) in x's memory layout, final state (*L,P,N) contiguous),
    both in x's dtype; the body by :func:`scan_route`.  ``_route=SEQ``
    runs bfloat16 on the sequential body where the rule would take the
    chunked one; only ``chip_smoke.py`` passes it, to check and time the
    earlier bf16 body."""
    ts = (x, dt, a, bmat, cmat)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("cuda_ssm_scan: x, dt, a, bmat and cmat must lie "
                         "on the same CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, bmat, cmat)):
        raise TypeError(f"cuda_ssm_scan: want x, dt, bmat, cmat in one "
                        f"dtype of float32 or bfloat16, got {x.dtype}, "
                        f"{dt.dtype}, {bmat.dtype}, {cmat.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"cuda_ssm_scan: a must be float32, got {a.dtype}")
    if x.dim() not in (3, 4):
        raise ValueError(f"cuda_ssm_scan: want x (G,S,P) or (B,H,S,P), got "
                         f"{tuple(x.shape)}")
    lead, (s, p) = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    n = bmat.shape[-1]
    if tuple(dt.shape) != lead + (s,) or tuple(a.shape) != lead \
            or tuple(bmat.shape) != lead + (s, n) \
            or tuple(cmat.shape) != lead + (s, n):
        raise ValueError(
            f"cuda_ssm_scan: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, bmat "
            f"{tuple(bmat.shape)}, cmat {tuple(cmat.shape)} do not agree")
    if not (0 < p <= MAX_P and 0 < n <= MAX_N):
        raise ValueError(f"cuda_ssm_scan: P={p}, N={n}: want 1..{MAX_P}, "
                         f"1..{MAX_N}")
    if any(t.stride(-1) != 1 for t in (x, bmat, cmat)):
        raise ValueError("cuda_ssm_scan: the P axis of x and the N axis of "
                         "bmat/cmat must be contiguous")
    route = scan_route(x, bmat, cmat)
    if _route is not None:
        if _route != SEQ:
            raise ValueError(f"cuda_ssm_scan: _route={_route}: only SEQ may "
                             f"be forced")
        route = SEQ
    y = empty_in_layout(x)
    final = torch.empty(lead + (p, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0 and final.numel() == 0:
        return y, final
    if x.dim() == 3:                     # (G,...) is (1, G, ...)
        x, dt, a, bmat, cmat, y4 = (t.unsqueeze(0)
                                    for t in (x, dt, a, bmat, cmat, y))
    else:
        y4 = y
    bsz, h = x.shape[:2]
    strides = (ctypes.c_int64 * 17)(
        *(t.stride(i) for t in (x, dt) for i in range(3)),
        a.stride(0), a.stride(1),
        *(t.stride(i) for t in (bmat, cmat, y4) for i in range(3)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), final.data_ptr(), strides, bsz, h, s,
        p, n, _DTYPES[x.dtype], route, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    _counted(route)
    return y, final
