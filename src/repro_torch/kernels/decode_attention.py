"""Flash decode: single-token attention over a KV cache with a valid
prefix per batch row.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_decode_attention`.  :func:`cuda_decode_attention` launches the
hand-written ``sm_90a`` kernel of ``csrc/decode_attention.cu`` (built at
first use) on CUDA tensors and raises on anything it does not take; the
dispatch between it and the plain version is :func:`repro_torch.kernels.
ops.decode_attention`.

The source has two bodies: the split-KV kernel (``SPLIT``: blocks over
slices of the cache, each serving a KV head's whole query group — bf16
on the tensor cores, f32 on the CUDA cores — merged by the last block
of each group to finish, found by an atomic ticket; :func:`plan_splits`
sizes the slices from the shapes alone), which every call takes, and
the earlier one-block-per-(b, h) body (``PREVIOUS``), reachable only
through the private ``_route`` keyword so that ``chip_smoke.py`` can
time the two side by side.  The tickets are one counter per (b, KV
head, head tile) a device, kept zero between launches; launches that
share them run in stream order (one stream, as the model's decode step
does).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

KERNEL = "decode_attention"
HEAD_DIMS = (64, 112, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PREVIOUS, SPLIT = 0, 1   # the launcher's routes
BLOCK_ROWS = 64          # the split kernel's slices: multiples of this
MAX_GROUP = 16           # query heads a block of the split kernel at most
MAX_SPLITS = 128
H100_SMS = 132

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


def plan_splits(w: int, b: int, kv: int, sms: int = H100_SMS
                ) -> tuple[int, int]:
    """``(splits, chunk)``: the split kernel cuts the W axis into
    ``splits`` slices of ``chunk`` rows (a multiple of ``BLOCK_ROWS``),
    enough for about two blocks an SM over the ``b * kv`` (batch row,
    KV head) pairs, at most ``MAX_SPLITS``.  A function of the shapes
    alone — never of the values in ``lengths`` — so a launch needs no
    host sync and a CUDA graph can hold it."""
    blocks = max(1, -(-w // BLOCK_ROWS))
    want = min(MAX_SPLITS, max(1, -(-2 * sms // max(1, b * kv))))
    per = -(-blocks // min(blocks, want))
    return -(-blocks // per), per * BLOCK_ROWS


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the merge tickets of each device: one counter per (b, kv head, head
# tile), zero between launches (the block that merges resets its own)
_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    t = _TICKETS.get(index)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "cuda_decode_attention: its merge tickets must be allocated "
                "before a CUDA graph captures it: call it once outside the "
                "capture at this batch and head count")
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[index] = t
    return t


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor, dims) -> bool:
    """Base pointer and the given strides on 16-byte boundaries (the
    previous body reads cache rows with 16-byte loads)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * size) % 16 == 0 for i in dims)


def cuda_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *,
                          _route: int = SPLIT) -> torch.Tensor:
    """The hand kernel: q (B,H,hd), k/v (B,KV,W,hd) — any element
    strides with a contiguous hd axis, e.g. a transposed view of a
    (B,W,KV,hd) cache; 16-byte copies where the pointers and strides
    allow them, element loads elsewhere — and int32 ``lengths`` (B,) on
    one CUDA device → (B,H,hd); hd 64, 112, 128 or 192.  ``_route=
    PREVIOUS`` runs the earlier body (16-byte aligned caches only); only
    ``chip_smoke.py`` passes it, to time the two."""
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
    if _route not in (PREVIOUS, SPLIT):
        raise ValueError(f"cuda_decode_attention: route {_route}")
    if _route == PREVIOUS and not (_aligned(k, range(3))
                                   and _aligned(v, range(3))):
        raise ValueError("cuda_decode_attention: the previous body needs "
                         "k/v base pointers and strides in multiples of 16 "
                         "bytes")
    lengths = lengths.contiguous()
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if w == 0:
        return out.zero_()
    splits = chunk = 0
    ws = tickets = None
    if _route == SPLIT:
        splits, chunk = plan_splits(w, b, kv, _sms(q.device.index or 0))
    if splits > 1:
        # (m, l) of each partial, padded to 16 bytes, then acc[hd] of each
        ml = -(-b * h * splits * 2 // 4) * 4
        ws = torch.empty(ml + b * h * splits * hd, dtype=torch.float32,
                         device=q.device)
        tickets = _tickets(q.device, b * kv * -(-(h // kv) // MAX_GROUP))
    strides = (ctypes.c_int64 * 10)(q.stride(0), q.stride(1),
                                    *(t.stride(i) for t in (k, v)
                                      for i in range(3)),
                                    out.stride(0), out.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), strides, b, h, w,
        hd, h // kv, hd ** -0.5, _DTYPES[q.dtype], _route, splits, chunk,
        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{err}")
    _counted()
    return out
