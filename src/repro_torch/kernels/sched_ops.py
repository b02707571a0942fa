"""Masked first-occurrence arg-extremum: the fleet's selection kernel.

Every selection the fleet scheduler makes per tick is the same
reduction: score a masked set of candidates and take the first extremum
— stealing a cloud-queued task (§5.3), picking a peer-offload export
victim, choosing the overloaded source and least-loaded destination
edge.  Port of ``repro.kernels.sched_ops`` (the Pallas TPU kernel
``_argext_kernel``); semantics in :func:`repro_torch.kernels.ref.
ref_masked_argext`.

Dispatch: a CUDA tensor goes to the hand-written ``sm_90a`` kernel in
``csrc/masked_argext.cu`` (built at first use; a build or launch failure
raises), a CPU tensor to the plain PyTorch version.  Nothing falls back
to the plain version on the card.  The source has two bodies: ``KEY``,
which every call takes (one 64-bit key an entry, a butterfly of
``max``; :func:`repro_torch.kernels.ref.ref_packed_argext` repeats its
arithmetic), and ``PREVIOUS``, the body before it, which only
``chip_smoke.py`` reaches (``_route=PREVIOUS``), to check and time it
beside the new one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.obs.prof import count, counters

NEG = ref.NEG
POS = ref.POS

KERNEL = "masked_argext"
PREVIOUS, KEY = 0, 1      # the launcher's routes
# the counters (repro_torch.obs.prof) of the hand kernel's launches (one
# per wrapper call on a CUDA tensor), and of those that took the KEY body;
# chip_smoke.py zeroes them before driving the main path
LAUNCHES = "masked_argext.launches"
KEY_LAUNCHES = "masked_argext.key_launches"


def reset_count() -> None:
    add_launches(*(-n for n in launch_counts()))


def launch_counts() -> tuple[int, int]:
    """``(launches, key launches)``."""
    c = counters()
    return c.get(LAUNCHES, 0), c.get(KEY_LAUNCHES, 0)


def add_launches(n: int, key: int) -> None:
    """Count ``n`` launches, ``key`` of them on KEY, that no wrapper call
    issued: a CUDA graph's replay of the launches its capture recorded
    (:class:`repro_torch.sim.fleet.TickProgram`; a capture launches
    nothing and takes its counts back)."""
    count(LAUNCHES, n)
    count(KEY_LAUNCHES, key)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.masked_argext_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def cuda_masked_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                       is_max: bool, _route: int = KEY
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hand kernel on ``(B, N)`` CUDA tensors (f32 scores, bool mask).
    ``_route=PREVIOUS`` runs the earlier body; only ``chip_smoke.py``
    passes it."""
    if scores.device.type != "cuda" or mask.device != scores.device:
        raise ValueError("cuda_masked_argext: scores and mask must lie on "
                         "the same CUDA device")
    if scores.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"cuda_masked_argext: want float32 scores and bool "
                        f"mask, got {scores.dtype} and {mask.dtype}")
    if scores.dim() != 2 or mask.shape != scores.shape:
        raise ValueError(f"cuda_masked_argext: want matching (B, N) tiles, "
                         f"got {tuple(scores.shape)} and {tuple(mask.shape)}")
    b, n = scores.shape
    if n < 1 or n >= 2**31:
        raise ValueError(f"cuda_masked_argext: N={n} out of range")
    if _route not in (PREVIOUS, KEY):
        raise ValueError(f"cuda_masked_argext: no route {_route}")
    scores = scores.contiguous()
    mask = mask.contiguous()
    idx = torch.empty(b, dtype=torch.int32, device=scores.device)
    val = torch.empty(b, dtype=torch.float32, device=scores.device)
    if b == 0:
        return idx, val
    fn = _lib().masked_argext_launch
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = fn(scores.data_ptr(), mask.data_ptr(), idx.data_ptr(),
             val.data_ptr(), b, n, int(is_max), _route, stream)
    if err != 0:
        raise RuntimeError(f"masked_argext launch failed: cudaError {err}")
    add_launches(1, int(_route == KEY))
    return idx, val


def masked_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                  is_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``scores, mask: (..., N)`` → ``(idx (...,) int32, val (...,) f32)``.

    CPU tensors take the plain version; CUDA tensors the hand kernel.
    """
    if scores.device.type == "cpu":
        return ref.ref_masked_argext(scores, mask, is_max=is_max)
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    s2 = scores.float().reshape(-1, n)
    m2 = torch.broadcast_to(mask, scores.shape).reshape(-1, n)
    idx, val = cuda_masked_argext(s2, m2, is_max=is_max)
    return idx.reshape(lead), val.reshape(lead)


def masked_argmax(scores, mask):
    """First argmax over enabled entries; (-1, NEG) when none enabled."""
    return masked_argext(scores, mask, is_max=True)


def masked_argmin(scores, mask):
    """First argmin over enabled entries; (-1, POS) when none enabled."""
    return masked_argext(scores, mask, is_max=False)
