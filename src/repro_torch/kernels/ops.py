"""Dispatch of the model zoo's kernels (attention, flash decode, RMSNorm,
the selective scan, the MoE grouped GEMM), in the manner of
:mod:`repro_torch.kernels.sched_ops`.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor takes the hand-written kernel, which raises on what it does not
take.  Nothing falls back to the plain version on the card.  Counterpart
of ``repro.kernels.ops``.

The kernels are forward-only, as the reference's Pallas kernels are (the
JAX package defines no ``custom_vjp`` for them, and differentiating its
``"pallas"`` route fails).  A kernel writes into a tensor it allocated
through ``ctypes``, so autograd would never see it and a loss taken
through it would drop every gradient upstream with no error.  So on the
card each dispatch first checks :func:`refuses_grad` on the host and
raises where grad mode is on and a floating input requires grad.  The
plain versions on the CPU stay differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gemm as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssm_scan as _ssm


def refuses_grad(*tensors: torch.Tensor) -> bool:
    """Whether a kernel launch on these inputs would lose a gradient:
    grad mode is on and a floating-point input requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.is_floating_point() for t in tensors)


def _check_forward_only(kernel: str, *tensors: torch.Tensor) -> None:
    if refuses_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: the hand-written kernel route (attn_impl='kernel') "
            f"is forward-only, as the reference's Pallas route is; an input "
            f"requires grad under grad mode. Train on attn_impl='ref', or "
            f"run the forward under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd)."""
    if q.device.type == "cpu":
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    _check_forward_only(_flash.KERNEL, q, k, v)
    return _flash.cuda_flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,KV,W,hd); lengths: (B,) → (B,H,hd)."""
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, lengths)
    _check_forward_only(_decode.KERNEL, q, k, v)
    return _decode.cuda_decode_attention(q, k, v, lengths.int())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) → x's shape and dtype."""
    if x.device.type == "cpu":
        return ref.ref_rmsnorm(x, scale, eps)
    _check_forward_only(_rms.KERNEL, x, scale)
    return _rms.cuda_rmsnorm(x, scale, eps)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (*L,S,P); dt: (*L,S); a: (*L); bmat/cmat: (*L,S,N), L = (G,) or
    (B, H) → (y (*L,S,P), final state (*L,P,N))."""
    if x.device.type == "cpu":
        return ref.ref_selective_scan(x, dt, a, bmat, cmat)
    _check_forward_only(_ssm.KERNEL, x, dt, a, bmat, cmat)
    return _ssm.cuda_ssm_scan(x, dt, a, bmat, cmat)


def moe_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """x_sorted: (T,D) rows sorted by expert; w: (E,D,F); offsets: (E+1,)
    → (T,F).  Rows outside [offsets[0], offsets[E]) differ between the
    routes (see :mod:`repro_torch.kernels.moe_gemm`)."""
    if x_sorted.device.type == "cpu":
        return ref.ref_moe_gemm(x_sorted, w, offsets)
    _check_forward_only(_moe.KERNEL, x_sorted, w)
    return _moe.cuda_moe_gemm(x_sorted, w, offsets.int())
