"""Shared model layers: norms, RoPE, activations, MLPs, GQA attention.

Port of ``repro.models.layers``: pure functions over explicit parameter
dicts of tensors.  The JAX package's logical-sharding annotations are
dropped (the port has no mesh), and so is its ``shard_map`` flash-decode,
which needs one.  Attention supports full-causal and sliding-window
(banded) masks, encoder (bidirectional) use, and single-token decode
against a (possibly ring-buffered) KV cache.  Every dtype cast sits where
the JAX code has it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

NEG = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             impl: str = "ref") -> torch.Tensor:
    """Variance in f32; the rsqrt is cast back to ``x.dtype`` before the
    products (the model's order).  ``impl="kernel"`` routes through the
    fused RMSNorm kernel (``kernels/ops.py``), which keeps the products
    in f32 and rounds once (``ref_rmsnorm``'s order); the two agree
    exactly in f32 up to the order of the sum."""
    if impl == "kernel":
        return ops.rmsnorm(x, scale, eps)
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":                          # jax.nn.gelu's default
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":                       # Nemotron-4 squared ReLU
        return lambda x: F.relu(x).square()
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding in f32, cast back; x: (..., S, H, hd),
    positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if cfg.act == "silu":                      # gated (SwiGLU-style)
        h = act(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = act(x @ p["wi"])
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV*groups, hd) for GQA."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def qkv_proj(p: dict, cfg: ArchConfig, x: torch.Tensor, positions,
             use_rope: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Reference attention (B, Sq, H, hd) × (B, Sk, KV, hd) → (B, Sq, H, hd).

    ``window`` > 0 applies a sliding-window band; ``q_offset`` is the
    absolute position of q[0] relative to k[0] (for chunked prefill).
    """
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


CHUNK_Q_THRESHOLD = 16_384
CHUNK_Q = 2_048


def attend_kernel(q, k, v, *, causal: bool, window: int = 0
                  ) -> torch.Tensor:
    """Route through the flash-attention kernel (``kernels/ops.py``).

    Layout adapters only: (B,S,H,hd) ↔ the kernel's (B,H,S,hd) /
    (B,KV,S,hd), as transposed views (the kernel takes strides and writes
    its output in ``q``'s layout, so nothing is copied).  The JAX
    package's ``attend_pallas``.
    """
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)


def attend_auto(q, k, v, *, causal: bool, window: int = 0,
                impl: str = "ref") -> torch.Tensor:
    """attend(), q-chunked above 16k tokens so the (Sq, Sk) logits never
    materialize; ``impl="kernel"`` dispatches to the flash kernel."""
    if impl == "kernel":
        return attend_kernel(q, k, v, causal=causal, window=window)
    b, s, h, hd = q.shape
    if s < CHUNK_Q_THRESHOLD:
        return attend(q, k, v, causal=causal, window=window)
    s_pad = -(-s // CHUNK_Q) * CHUNK_Q
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    outs = [attend(q[:, i:i + CHUNK_Q], k, v, causal=causal, window=window,
                   q_offset=i) for i in range(0, s_pad, CHUNK_Q)]
    return torch.cat(outs, dim=1)[:, :s]


def attention_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = qkv_proj(p, cfg, x, positions, use_rope)
    w = cfg.sliding_window if window is None else window
    out = attend_auto(q, k, v, causal=causal, window=w, impl=cfg.attn_impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# KV cache (contiguous or ring-buffered for sliding windows)
# ---------------------------------------------------------------------------

def cache_width(cfg: ArchConfig, max_seq: int) -> int:
    """Sliding-window archs only ever hold `window` keys; full attention
    holds the whole sequence."""
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_seq: int,
                  dtype, device) -> dict:
    w = cache_width(cfg, max_seq)
    shape = (n_layers, batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
                  pos: int, window: int) -> torch.Tensor:
    """Single-token attention over the cache.

    q: (B, 1, H, hd); ck/cv: (B, W, KV, hd); ``pos`` is the absolute
    position of the new token (its K/V already written to the cache).
    The query heads are grouped per KV head, so the cache is never
    repeated ``groups``×.
    """
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    groups = h // kv
    qg = q.reshape(b, kv, groups, hd)        # query heads per KV head
    scale = hd ** -0.5
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * scale
    w = ck.shape[1]
    slots = torch.arange(w, device=q.device)
    if window:
        # ring buffer: slot s holds absolute position pos − ((pos − s) % w);
        # it is valid iff it has been written at all
        valid = (pos - slots) % w <= pos
    else:
        valid = slots <= pos
    logits = torch.where(valid, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv)    # (B, KV, G, hd)
    return out.reshape(b, 1, h, hd)
