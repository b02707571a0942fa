"""Mamba2-style selective state-space block (SSD): forward, prefill and
decode.

Port of ``repro.models.ssm``.  :func:`ssd_chunked` is the plain path, the
JAX package's chunkwise-parallel SSD form (an intra-chunk quadratic term
plus a recurrence over chunk states), with its clipping and dtype casts.
:func:`ssd_scan` is the kernel route: the same block with its scan in the
hand-written selective-scan kernel (``kernels/ops.py``), which reads the
input projection's slices in place.  Decoding is the O(1) recurrent
update (:func:`ssd_decode_step`), plain in both routes as in the JAX
package.  The depthwise conv of the reference Mamba2 is folded away
(identity), as there.

Shapes: heads H = d_inner / ssm_head_dim, head dim P = ssm_head_dim,
state N = cfg.ssm_state.  State cache per layer: (B, H, P, N).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

CHUNK = 128


def _split_in_proj(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x (B,S,D) → z, xs (B,S,H,P), B, C (B,S,N), dt (B,S,H).

    z, xs, B and C are views into the projection; dt is
    ``softplus(dt + dt_bias)``."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = L.matmul(x, p["w_in"])        # (B,S, 2*di + 2*n + h)
    z, xs, bmat, cmat, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    b, s, _ = x.shape
    z = z.reshape(b, s, h, cfg.ssm_head_dim)
    xs = xs.reshape(b, s, h, cfg.ssm_head_dim)
    dt = F.softplus(dt + p["dt_bias"])               # (B,S,H) > 0
    return z, xs, bmat, cmat, dt


def _gate_out(p: dict, cfg: ArchConfig, y: torch.Tensor, xs: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """D skip, silu(z) gate and output projection: y (B,S,H,P) → (B,S,D)."""
    b, s = y.shape[:2]
    y = y + xs * p["d_skip"][None, None, :, None]    # D skip connection
    y = y * F.silu(z)                                # gated output
    return L.matmul(y.reshape(b, s, cfg.d_inner), p["w_out"])


def ssd_chunked(p: dict, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Chunkwise-parallel SSD scan over the full sequence (plain path).

    Returns (out (B,S,D), final state (B,H,P,N) in ``x.dtype``).
    """
    b, s, _ = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xs, bmat, cmat, dt = _split_in_proj(p, cfg, x)
    a = -torch.exp(p["a_log"])                       # (H,) negative decay

    nc = max(1, s // CHUNK)
    c = s // nc
    if nc * c != s:
        raise ValueError(f"ssd_chunked: seq {s} not divisible by chunk {c}")

    xs_c = xs.reshape(b, nc, c, h, pd)
    b_c = bmat.reshape(b, nc, c, n)
    c_c = cmat.reshape(b, nc, c, n)
    dt_c = dt.reshape(b, nc, c, h)

    # per-step log decay  ℓ_t = a·dt_t  (per head), cumulated in a chunk
    ldec = dt_c * a[None, None, None, :]             # (B,nc,c,H) ≤ 0
    cum = L.shard_local(functools.partial(torch.cumsum, dim=2), ldec, 2)

    # intra-chunk: M[i,j] = exp(cum_i − cum_j) · (C_i·B_j) · dt_j, i ≥ j
    ci = cum[:, :, :, None, :]                       # (B,nc,c,1,H)
    cj = cum[:, :, None, :, :]                       # (B,nc,1,c,H)
    decay = torch.exp(torch.clamp(ci - cj, -60.0, 0.0))
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    cb = L.einsum("bgin,bgjn->bgij", c_c, b_c)   # (B,nc,c,c)
    m = cb[..., None] * decay * dt_c[:, :, None, :, :]
    m = torch.where(causal[None, None, :, :, None], m, 0.0)
    y_intra = L.einsum("bgijh,bgjhp->bgihp", m, xs_c)

    # chunk summaries: S_g = Σ_j exp(cum_end − cum_j) dt_j B_j x_j
    tail = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, -60.0, 0.0))
    sum_g = L.einsum("bgjh,bgjn,bgjhp->bghpn", tail * dt_c, b_c, xs_c)
    chunk_decay = torch.exp(torch.clamp(cum[:, :, -1, :], -60.0, 0.0))

    # inter-chunk recurrence over chunk states, in f32; each chunk sees
    # the state *before* it
    carry = (state if state is not None
             else torch.zeros((b, h, pd, n), dtype=x.dtype,
                              device=x.device)).float()
    prev = []
    for g in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, g, :, None, None].float() \
            + sum_g[:, g].float()
    prev_states = torch.stack(prev, 1)               # (B,nc,H,P,N)

    # the carried state's contribution: y_t += C_t · (decay_to_t · S_prev)
    into = torch.exp(torch.clamp(cum, -60.0, 0.0))   # from chunk start
    y_inter = L.einsum("bgin,bgih,bghpn->bgihp", c_c, into,
                           prev_states.to(x.dtype))

    y = (y_intra + y_inter).reshape(b, s, h, pd)
    return _gate_out(p, cfg, y, xs, z), carry.to(x.dtype)


def ssd_scan(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """The same block from a zero state through the selective-scan kernel
    (kernel route): one sequence per (batch, head), ``xs``/``dt`` read
    through transposed views, ``B``/``C`` through a zero head stride, the
    decay as a stride-0 broadcast, and ``y`` written in ``xs``'s
    (B,S,H,P) layout.  Returns (out (B,S,D), final state (B,H,P,N)), the
    final state straight from the kernel."""
    z, xs, bmat, cmat, dt = _split_in_proj(p, cfg, x)
    b, s, h, _ = xs.shape
    n = cfg.ssm_state
    a = (-torch.exp(p["a_log"])).float()             # exact upcast
    y, final = ops.ssm_scan(
        xs.transpose(1, 2), dt.transpose(1, 2), a.expand(b, h),
        bmat[:, None].expand(b, h, s, n), cmat[:, None].expand(b, h, s, n))
    return _gate_out(p, cfg, y.transpose(1, 2), xs, z), final


def ssd_block(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """The SSD block from a zero state on ``cfg.attn_impl``'s route."""
    if cfg.attn_impl == "kernel":
        return ssd_scan(p, cfg, x)
    return ssd_chunked(p, cfg, x)


def ssd_decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    state: torch.Tensor):
    """One-token recurrent update.  x: (B,1,D); state: (B,H,P,N)."""
    z, xs, bmat, cmat, dt = _split_in_proj(p, cfg, x)
    a = -torch.exp(p["a_log"])
    dec = torch.exp(dt[:, 0, :] * a[None, :])        # (B,H)
    # state ← decay·state + dt·x_t ⊗ B_t
    upd = L.einsum("bhp,bn,bh->bhpn", xs[:, 0], bmat[:, 0], dt[:, 0])
    state = state * dec[:, :, None, None] + upd
    y = L.einsum("bn,bhpn->bhp", cmat[:, 0], state)  # C_t · state
    y = y + xs[:, 0] * p["d_skip"][None, :, None]
    y = (y * F.silu(z[:, 0]))[:, None]               # (B,1,H,P)
    b = x.shape[0]
    out = y.reshape(b, 1, cfg.d_inner) @ p["w_out"]
    return out, state
