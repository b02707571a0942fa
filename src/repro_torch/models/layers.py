"""Shared model layers: norms, RoPE, activations, MLPs, GQA attention.

Port of ``repro.models.layers``: pure functions over explicit parameter
dicts of tensors, with the JAX package's logical-axis annotations
(:func:`~repro_torch.launch.sharding.shard`: they place a DTensor under
active rules and pass a plain tensor through).  Attention supports
full-causal and sliding-window (banded) masks, encoder (bidirectional)
use, and single-token decode against a (possibly ring-buffered) KV
cache.  Every dtype cast sits where
the JAX code has it.  The JAX package's ``shard_map`` flash-decode is
:func:`decode_update_attend_sharded`, one process a rank of the mesh
that :func:`repro_torch.launch.sharding.sharding_rules` activates, the
combine done by ``torch.distributed`` collectives.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch.sharding import (current_mesh, mesh_shape,
                                         placements, resolves, shard)

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
    x = foldable(x)
    if cfg.act == "silu":                      # gated (SwiGLU-style)
        h = act(fold_grad(x @ p["wg"])) * fold_grad(x @ p["wu"])
    else:
        h = act(fold_grad(x @ p["wi"]))
    # keep the token dim sharded when the arch cannot head-shard
    seq_ax = "seq" if resolves(cfg.n_heads, "heads") else "act_seq"
    h = shard(h, "batch", seq_ax, "mlp")
    return fold_grad(foldable(h) @ p["wd"])


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


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) · w (D, H, K) → (B, S, H, K), ``bsd,dhk->bshk``, as one
    ``x @ w.flatten(1)`` (an ``aten.mm``, whose output remat ``"dots"``
    saves, as the JAX policy saves the projections) unflattened.

    A DTensor's (H·K) columns are first gathered off any mesh axis that
    does not divide H: DTensor cannot unflatten such a split (grok's or
    granite's 8 KV heads on a 16-way model axis)."""
    wf = _Flatten.apply(w) if isinstance(w, DTensor) else w.flatten(1)
    return unflatten(fold_grad(foldable(x) @ wf), -1, tuple(w.shape[1:]))


def foldable(x):
    """``x`` ready for a product that folds its leading dimensions: a
    DTensor split along any of them but the first is gathered along it
    (DTensor refuses to flatten a split that is not the first folded
    dimension; a split sequence, ``act_seq``, is gathered before the
    projections, as sequence parallelism gathers it).  A plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    keep = [Replicate() if any(pl.is_shard(d) for d in range(1, x.dim() - 1))
            else pl for pl in x.placements]
    if keep == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, keep)


def matmul(x, w):
    """``x @ w`` of activations x (..., D): a DTensor made
    :func:`foldable` first, its gradient too (:func:`fold_grad`); a
    plain tensor as it is."""
    return fold_grad(foldable(x) @ w)


def einsum(eq: str, *xs):
    """``torch.einsum(eq, *xs)``.  With a DTensor among the operands each
    is first gathered to a split of its first dimension alone, and the
    result's gradient too (:func:`batch_split`): the product then folds
    no split but the first dimension's (torch 2.11's DTensor refuses to
    flatten a batch split with a head split).  Plain operands go to
    ``torch.einsum`` as they are."""
    if not any(isinstance(x, DTensor) for x in xs):
        return torch.einsum(eq, *xs)
    return _GatherGrad.apply(torch.einsum(eq, *map(batch_split, xs)),
                             batch_split)


def batch_split(x):
    """A DTensor gathered along every split but its first dimension's (a
    plain tensor as it is)."""
    if not isinstance(x, DTensor):
        return x
    keep = [Replicate() if pl.is_shard() and not pl.is_shard(0) else pl
            for pl in x.placements]
    if keep == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, keep)


def fold_grad(y):
    """``y`` as it is, its gradient made :func:`foldable` on the way back:
    the backward of the product that made ``y`` folds that gradient's
    leading dimensions too.  A plain tensor is returned as it is."""
    return _GatherGrad.apply(y, foldable) if isinstance(y, DTensor) else y


class _GatherGrad(torch.autograd.Function):
    """``y`` as it is, its gradient passed through ``gather`` (a DTensor
    redistribution) on the way back."""

    @staticmethod
    def forward(ctx, y, gather):
        ctx.gather = gather
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.gather(g), None


class _Flatten(torch.autograd.Function):
    """``w.flatten(1)`` whose gradient comes back through :func:`unflatten`
    (the plain view's backward would unflatten a split DTensor cannot)."""

    @staticmethod
    def forward(ctx, w):
        ctx.sizes = tuple(w.shape[1:])
        return w.flatten(1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, 1, ctx.sizes)


def unflatten(y, dim: int, sizes: tuple):
    """``y.unflatten(dim, sizes)``; a DTensor split along ``dim`` over a
    mesh axis that does not divide ``sizes[0]`` is first gathered along
    that axis (DTensor cannot unflatten such a split)."""
    if isinstance(y, DTensor):
        mesh, dim = y.device_mesh, dim % y.dim()
        keep = [Replicate() if pl.is_shard(dim) and sizes[0] % mesh.size(i)
                else pl for i, pl in enumerate(y.placements)]
        if keep != list(y.placements):
            y = y.redistribute(mesh, keep)
    return y.unflatten(dim, sizes)


def qkv_proj(p: dict, cfg: ArchConfig, x: torch.Tensor, positions,
             use_rope: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = project(x, p["wq"]), project(x, p["wk"]), project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # when heads cannot take the model axis keep the sequence sharded
    q_seq = "seq" if resolves(q.shape[2], "heads") else "act_seq"
    kv_seq_ax = "seq" if resolves(k.shape[2], "kv_heads") else "act_seq"
    q = shard(q, "batch", q_seq, "heads", "head_dim")
    k = shard(k, "batch", kv_seq_ax, "kv_heads", "head_dim")
    v = shard(v, "batch", kv_seq_ax, "kv_heads", "head_dim")
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Reference attention (B, Sq, H, hd) × (B, Sk, KV, hd) → (B, Sq, H, hd).

    DTensors run it shard-locally (:func:`_attend_local`).

    ``window`` > 0 applies a sliding-window band; ``q_offset`` is the
    absolute position of q[0] relative to k[0] (for chunked prefill).
    """
    if isinstance(q, DTensor):
        return _attend_local(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
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
    logits = shard(logits, "batch", "heads", "seq_model", None)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", probs, v)
    seq_ax = "seq" if resolves(q.shape[2], "heads") else "act_seq"
    return shard(out, "batch", seq_ax, "heads", "head_dim")


def _attend_local(q, k, v, **kw):
    """:func:`attend` on DTensors, each rank on its own batch rows and heads
    (``local_map``, the counterpart of the partitioner's: attention is
    independent across both).  K/V are repeated to the query heads and
    laid out as q is, with q's splits kept only on the batch and heads
    dimensions; the sequences are whole on every rank."""
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    mesh = q.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in q.placements]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    fn = local_map(functools.partial(attend, **kw), out_placements=pl,
                   in_placements=(pl, pl, pl), device_mesh=mesh)
    return fn(q, k, v)


def shard_local(fn, x, whole: Optional[int] = None):
    """``fn(x)`` for an ``fn`` that works on any split of ``x`` but along
    ``whole`` (an elementwise op; a scan along ``whole``).  A DTensor runs
    it on each rank's own shard (``local_map``; a pending sum reduced
    and a split of ``whole`` gathered first), so that its backward is the
    local op's: torch 2.11's DTensor has no rule for
    ``log_sigmoid_backward``, nor for the ``flip`` in a cumulative sum's.
    A plain tensor is passed to ``fn`` as it is."""
    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() or (
        whole is not None and p.is_shard(whole % x.dim())) else p
        for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh)(x.redistribute(mesh, pl))


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
    return fold_grad(torch.einsum("bshk,hkd->bsd", out, p["wo"]))


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


def position(pos, device) -> torch.Tensor:
    """A decode step's position as a 0-d integer tensor, as the JAX
    package's step takes an int32 scalar: a tensor passes through (a
    replicated DTensor as its local value), a host int becomes an int32
    tensor on ``device`` by a fill, which reads nothing back."""
    if isinstance(pos, DTensor):
        pos = pos.to_local()
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.is_floating_point():
            raise ValueError(f"decode position: want an int or a 0-d "
                             f"integer tensor, got {pos.dtype} of shape "
                             f"{tuple(pos.shape)}")
        return pos
    return torch.full((), pos, dtype=torch.int32, device=device)


def cache_slot(pos: torch.Tensor, w: int, window: int) -> torch.Tensor:
    """The slot of a W-wide cache that position ``pos`` writes:
    ``pos % W`` in a sliding window's ring, else ``pos`` clamped to
    ``W − 1`` (a full cache keeps overwriting its last slot)."""
    return pos % w if window else torch.clamp(pos, max=w - 1)


def write_slot(layer, slot: torch.Tensor, row) -> None:
    """``layer[:, slot] = row[:, 0]`` in place for a 0-d ``slot`` tensor:
    an ``index_copy_``, which reads no index back to the host (an
    indexing by a tensor would, and a CUDA graph cannot capture it).  A
    DTensor layer is written through a ``where`` and copied back (torch
    2.11's DTensor has no rule for ``index_copy``)."""
    if isinstance(layer, DTensor):
        hit = torch.arange(layer.shape[1], device=slot.device) == slot
        layer.copy_(torch.where(hit[:, None, None], row, layer))
        return
    layer.index_copy_(1, slot.reshape(1).long(), row)


def decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
                  pos, window: int) -> torch.Tensor:
    """Single-token attention over the cache.

    q: (B, 1, H, hd); ck/cv: (B, W, KV, hd); ``pos`` is the absolute
    position of the new token (its K/V already written to the cache), an
    int or a 0-d tensor.
    The query heads are grouped per KV head, so the cache is never
    repeated ``groups``×.
    """
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    groups = h // kv
    qg = unflatten(q[:, 0], 1, (kv, groups))  # query heads per KV head
    scale = hd ** -0.5
    # a DTensor query and probabilities fold their head splits (torch
    # 2.11 cannot flatten them with the batch's); the cache keeps its
    # sequence split, which the contraction reduces across
    logits = torch.einsum("bkgd,bskd->bkgs", foldable(qg), ck).float() \
        * scale
    w = ck.shape[1]
    slots = torch.arange(w, device=q.device)
    if window:
        # ring buffer: slot s holds absolute position pos − ((pos − s) % w);
        # it is valid iff it has been written at all
        valid = (pos - slots) % w <= pos
    else:
        valid = slots <= pos
    logits = torch.where(valid, logits, NEG)
    logits = shard(logits, "batch", "kv_heads", None, "kv_seq")
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", foldable(probs), cv)  # (B,KV,G,hd)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# sharded flash-decode over the mesh's "model" axis (opt_decode)
# ---------------------------------------------------------------------------

def decode_cache_axes(mesh, b: int, w: int) -> tuple:
    """How :func:`decode_update_attend_sharded` splits a (B, W, KV, hd)
    cache layer: (batch mesh axes — ``("pod", "data")`` where present and
    their product divides B, else none —, whether W splits over
    ``"model"``)."""
    sizes = mesh_shape(mesh)
    batch_ax = tuple(a for a in ("pod", "data") if a in sizes)
    if b % math.prod(sizes[a] for a in batch_ax):
        batch_ax = ()
    return batch_ax, w % sizes["model"] == 0


def shard_decode_cache(cache: dict, mesh) -> dict:
    """The ``"k"``/``"v"`` leaves (L, B, W, KV, hd) of a cache that every
    rank holds whole, as DTensors split the way
    :func:`decode_update_attend_sharded` reads them (each rank keeps a
    copy of its own block; no collective).  Other leaves pass through."""
    out = dict(cache)
    for key in ("k", "v"):
        c = cache[key]
        batch_ax, seq = decode_cache_axes(mesh, c.shape[1], c.shape[2])
        spec = (None, batch_ax or None, "model" if seq else None)
        (blo, bhi), (wlo, whi) = _block(mesh, c.shape[1], batch_ax), \
            _block(mesh, c.shape[2], ("model",) if seq else ())
        out[key] = DTensor.from_local(
            c[:, blo:bhi, wlo:whi].contiguous(), mesh,
            placements(spec, mesh), run_check=False, shape=c.shape,
            stride=c.stride())
    return out


def _block(mesh, n: int, axes: tuple) -> tuple:
    """This rank's [lo, hi) of a dimension of n split over mesh ``axes``
    (major to minor)."""
    sizes = mesh_shape(mesh)
    idx, parts = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        parts *= sizes[a]
    size = n // parts
    return idx * size, (idx + 1) * size


def decode_update_attend_sharded(cfg: ArchConfig, q, k_new, v_new, ck, cv,
                                 pos, window: int) -> torch.Tensor:
    """Cache update + single-token attention with the cache's sequence
    split over the ``"model"`` ranks of the active mesh (flash-decode).

    Each model rank owns a contiguous ``W/n`` slice of every cache layer
    and the batch rows of its ``("pod", "data")`` block where those axes
    divide B (:func:`decode_cache_axes`).  The owner of the write slot
    writes the new K/V; every rank forms the partial online softmax of its
    slice; ``m`` is combined by an all-reduce MAX and ``l`` and ``o`` by
    all-reduce SUMs over the model group, so the bytes a step exchanges
    are O(q), not O(cache).  A model axis of 1 issues no collective.

    ``pos`` is an int or a 0-d integer tensor (:func:`position`); no
    rank reads it back: the owner's write is a masked row.

    q: (B, 1, H, hd); k_new/v_new: (B, 1, KV, hd); ck/cv: (B, W, KV, hd),
    either a DTensor laid out by :func:`shard_decode_cache` (each rank
    writes and reads its own block) or a plain tensor every rank holds
    whole (each rank writes the new K/V into its copy, and reads its
    block of it).  Returns out (B, 1, H, hd), the batch gathered back
    over the data ranks when it was split.
    """
    mesh = current_mesh()
    sizes = mesh_shape(mesh)
    if isinstance(q, DTensor):
        q, k_new, v_new = (t.full_tensor() for t in (q, k_new, v_new))
    b, _, h, hd = q.shape
    w, kv = ck.shape[1], ck.shape[2]
    groups = h // kv
    batch_ax, seq = decode_cache_axes(mesh, b, w)
    n_model = sizes["model"] if seq else 1
    blo, bhi = _block(mesh, b, batch_ax)
    my_lo, my_hi = _block(mesh, w, ("model",) if seq else ())
    w_loc = my_hi - my_lo
    pos = position(pos, q.device)
    slot = cache_slot(pos, w, window)
    if isinstance(ck, DTensor):
        ck_l, cv_l = ck.to_local(), cv.to_local()
        # the owner writes the new row; every other rank writes back the
        # row it holds at the clamped index
        loc = slot - my_lo
        owner = (loc >= 0) & (loc < w_loc)
        idx = loc.clamp(0, w_loc - 1)
        for c_l, new in ((ck_l, k_new), (cv_l, v_new)):
            old = c_l.index_select(1, idx.reshape(1).long())
            write_slot(c_l, idx, torch.where(owner, new[blo:bhi], old))
    else:
        write_slot(ck, slot, k_new)
        write_slot(cv, slot, v_new)
        ck_l = ck[blo:bhi, my_lo:my_hi]
        cv_l = cv[blo:bhi, my_lo:my_hi]

    q_l = q[blo:bhi]
    bl = q_l.shape[0]
    qg = q_l.reshape(bl, kv, groups, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck_l).float() * hd ** -0.5
    slots = my_lo + torch.arange(w_loc, device=q.device)
    valid = (pos - slots) % w <= pos if window else slots <= pos
    logits = torch.where(valid, logits, NEG)
    m = logits.amax(-1)                                  # (B, KV, G)
    group = mesh.get_group("model") if n_model > 1 else None
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p_ = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l_ = p_.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p_.to(q.dtype), cv_l).float()
    if group is not None:
        dist.all_reduce(l_, group=group)
        dist.all_reduce(o, group=group)
    out = (o / l_.clamp_min(1e-30)[..., None]).to(q.dtype)
    out = out.reshape(bl, 1, h, hd)
    for a in reversed(batch_ax):             # minor axis first
        if sizes[a] > 1:
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out.contiguous(),
                            group=mesh.get_group(a))
            out = torch.cat(parts, 0)
    return out
