"""Dispatch of the model zoo's attention kernels, in the manner of
:mod:`repro_torch.kernels.sched_ops`.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor takes the hand-written kernel, which raises on what it does not
take.  Nothing falls back to the plain version on the card.  Counterpart
of the attention half of ``repro.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd)."""
    if q.device.type == "cpu":
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    return _flash.cuda_flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,KV,W,hd); lengths: (B,) → (B,H,hd)."""
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, lengths)
    return _decode.cuda_decode_attention(q, k, v, lengths.int())
