"""Mixture-of-Experts layer: top-k router with group-wise capacity dispatch.

Port of ``repro.models.moe``.  Tokens are reshaped into ``cfg.moe_groups``
groups (halved until they divide the token count), and dispatch — stable
sort by expert, rank within the expert, capacity drop — happens
independently per group; the JAX package's ``vmap`` over groups is an
explicit leading group axis here.  Capacity is per call:
``int(tg · top_k / n_experts · capacity_factor) + 1`` for tg tokens a
group, so forward, prefill and decode each dispatch over their own T.

The capacity buffer is built expert-major: (E·g·C, D) rows ordered
(expert, group, slot), plus one trash row that every dropped pair writes
to.  It is thus sorted by expert, with the constant offsets
``arange(E+1)·g·C``, and feeds the grouped-GEMM kernel as it stands
under ``cfg.attn_impl == "kernel"``: ``ops.moe_gemm`` for ``we_g`` and
``we_u`` (or ``we_i``) on the buffer and ``we_d`` on the hidden rows, the
rows the JAX package's einsums multiply, row for row.  Under ``"ref"``
the same buffer goes through those einsums (``gecd,edf->gecf``, then
``gecf,efd->gecd``).  Nothing here syncs with the host: shapes and
offsets are static, counts come from a sorted search, not ``bincount``
(which reads its maximum on the host).

``cfg.expert_split`` s > 1 takes the JAX package's split-expert layout:
each expert's d_ff split s ways, ``(E·s, D, Fe/s)`` up and
``(E·s, Fe/s, D)`` down, so that the merged expert dimension divides a
model-parallel axis (grok's 8 experts on 16 ranks).  Under ``"ref"`` the
JAX einsums run on the split views (``gecd,esdf->gescf``, then
``gescf,esfd->gecd``, which sums the s partials).  Under ``"kernel"``
the up projections are one grouped-GEMM launch a split, each on the
strided view ``w.view(E, s, D, Fe/s)[:, j]`` (the kernel takes the
expert stride), and the down projection is one launch on the contiguous
``(E, s·Fe/s, D)`` view of ``we_d`` against the splits' hidden rows side
by side: no expert weight is copied.  ``expert_split == -1`` ("auto",
resolved against a mesh by :func:`repro_torch.launch.dryrun.build`) is
refused here.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch.sharding import shard
from repro_torch.models import layers as L

# offsets of the expert-major buffer, one device tensor per shape
_OFFSETS: dict = {}


def check_expert_split(cfg: ArchConfig) -> None:
    """Refuse an expert split a model cannot take: s < 1 (``-1``, "auto",
    is resolved against a mesh before a model is built), or an s that does
    not divide d_ff_expert."""
    s = cfg.expert_split
    if s < 1:
        raise ValueError(
            f"{cfg.name}: expert_split {s} is unresolved; 'auto' (-1) is "
            f"resolved against a mesh by launch.dryrun.build")
    if cfg.d_ff_expert % s:
        raise ValueError(f"{cfg.name}: expert_split {s} does not divide "
                         f"d_ff_expert {cfg.d_ff_expert}")


def router(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of x (..., T, D) over the last token axis.

    Returns (weights (..., T, k) in x's dtype, experts (..., T, k) int64,
    aux (...,) f32).  Ties go to the lower expert index, as with
    ``jax.lax.top_k``: a stable descending sort, not ``torch.topk``.
    """
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # (.., T, E)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = srt[..., :cfg.top_k], idx[..., :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Shazeer-style load-balance auxiliary loss
    density = F.one_hot(experts[..., 0], cfg.n_experts).float().mean(-2)
    mean_probs = probs.mean(-2)
    aux = cfg.router_aux_coef * cfg.n_experts * (density * mean_probs).sum(-1)
    return weights.to(x.dtype), experts, aux


def capacity_dispatch(experts: torch.Tensor, n_experts: int, capacity: int):
    """Assign each (token, k) pair a slot in an (E, C) buffer, per group.

    experts: (g, T, k).  Returns (slot (g, T·k), keep (g, T·k)) where
    ``slot = e·C + rank`` for kept pairs, rank counting the group's earlier
    pairs (in (token, k) order) routed to the same expert; pairs past an
    expert's capacity are dropped, their slot clipped to the expert's last.
    """
    g = experts.shape[0]
    flat = experts.reshape(g, -1)                                # (g, T·k)
    tk = flat.shape[1]
    srt, order = torch.sort(flat, dim=-1, stable=True)
    # first sorted position of every expert: its rows start there
    start = torch.searchsorted(
        srt, torch.arange(n_experts, device=flat.device).repeat(g, 1))
    pos = torch.arange(tk, device=flat.device).expand(g, -1)
    sorted_rank = pos - torch.gather(start, 1, srt)
    rank = torch.empty_like(sorted_rank).scatter_(1, order, sorted_rank)
    keep = rank < capacity
    slot = flat * capacity + rank.clamp_max(capacity - 1)
    return slot, keep


def _buffer_rows(slot: torch.Tensor, capacity: int, groups: int):
    """Row of each pair's slot in the expert-major (E·g·C, D) buffer:
    slot e·C + c of group gi sits at row (e·g + gi)·C + c."""
    gi = torch.arange(groups, device=slot.device)[:, None]
    e, c = slot // capacity, slot % capacity
    return (e * groups + gi) * capacity + c


def _offsets(n_experts: int, rows: int, device) -> torch.Tensor:
    """``arange(E+1)·rows`` as int32 on ``device``, built once a shape."""
    key = (n_experts, rows, str(device))
    off = _OFFSETS.get(key)
    if off is None:
        off = (torch.arange(n_experts + 1, dtype=torch.int32, device=device)
               * rows)
        _OFFSETS[key] = off
    return off


def _up_and_hidden(cfg: ArchConfig):
    """The experts' up-projection names and the hidden activation of
    their outputs: silu(gate)·up, or gelu of the one input projection."""
    act = L.activation(cfg.act)
    if cfg.act == "silu":
        return ("we_g", "we_u"), lambda hs: act(hs[0]) * hs[1]
    return ("we_i",), lambda hs: act(hs[0])


def _expert_mlp(p: dict, cfg: ArchConfig, buf: torch.Tensor, groups: int,
                capacity: int) -> torch.Tensor:
    """The experts' MLP on the (E·g·C, D) buffer → (E·g·C, D)."""
    e, d, sp = cfg.n_experts, buf.shape[-1], cfg.expert_split
    up, hidden = _up_and_hidden(cfg)

    if cfg.attn_impl == "kernel":
        off = _offsets(e, groups * capacity, buf.device)
        if sp == 1:
            h = hidden([ops.moe_gemm(buf, p[name], off) for name in up])
            return ops.moe_gemm(h, p["we_d"], off)
        f2 = p["we_d"].shape[1]
        views = {name: p[name].view(e, sp, d, f2) for name in up}
        h = torch.cat([hidden([ops.moe_gemm(buf, views[name][:, j], off)
                               for name in up]) for j in range(sp)], -1)
        return ops.moe_gemm(h, p["we_d"].view(e, sp * f2, d), off)
    # the JAX package's einsums, over a (g, E, C, D) view of the buffer
    gecd = buf.view(e, groups, capacity, d).transpose(0, 1)
    return _expert_einsums(p, cfg, gecd).transpose(0, 1).reshape(-1, d)


def _expert_einsums(p: dict, cfg: ArchConfig, gecd: torch.Tensor
                    ) -> torch.Tensor:
    """The experts' MLP as the JAX package's einsums: (g, E, C, D) →
    (g, E, C, D)."""
    e, d, sp = cfg.n_experts, gecd.shape[-1], cfg.expert_split
    up, hidden = _up_and_hidden(cfg)

    if sp == 1:
        h = hidden([L.einsum("gecd,edf->gecf", gecd, p[name])
                    for name in up])
        out = L.einsum("gecf,efd->gecd", h, p["we_d"])
    else:
        f2 = p["we_d"].shape[1]
        h = hidden([L.einsum("gecd,esdf->gescf", gecd,
                             p[name].view(e, sp, d, f2)) for name in up])
        out = L.einsum("gescf,esfd->gecd", h, p["we_d"].view(e, sp, f2, d))
    return out


def _dispatch_local(xf, experts, n_experts: int, capacity: int):
    """Each group's (E, C, D) buffer of its tokens' copies (the JAX
    package's ``_dispatch_group`` over the groups): (g, E, C, D), and
    the pairs' slots and keep flags."""
    g, tg, d = xf.shape
    k = experts.shape[-1]
    slot, keep = capacity_dispatch(experts, n_experts, capacity)
    trash = n_experts * capacity
    buf = torch.zeros((g, trash + 1, d), dtype=xf.dtype, device=xf.device)
    gi = torch.arange(g, device=xf.device)[:, None]
    buf[gi, torch.where(keep, slot, trash)] = \
        xf[:, :, None, :].expand(g, tg, k, d).reshape(g, tg * k, d)
    return buf[:, :-1].view(g, n_experts, capacity, d), slot, keep


def _combine_local(out, slot, keep, weights):
    """Each token's k expert rows, weighted and summed in order: (g, E,
    C, D) → (g, T, D)."""
    g, e, c, d = out.shape
    rows = torch.gather(out.reshape(g, e * c, d), 1,
                        slot[..., None].expand(-1, -1, d))
    gathered = rows * (weights.reshape(g, -1, 1) * keep[..., None])
    return gathered.view(g, -1, weights.shape[-1], d).sum(2)


def _moe_sharded(p: dict, cfg: ArchConfig, xf, weights, experts,
                 capacity: int):
    """The dispatch, experts and combine on DTensors, as the JAX package
    shards them: dispatch and combine on each rank's own groups
    (``local_map``: DTensor has no rule for ``searchsorted`` and cannot
    place an indexed write into a split buffer), the (g, E, C, D) buffer
    split over groups and experts, the experts' einsums between."""
    mesh = xf.device_mesh
    grp = [pl if pl.is_shard(0) else Replicate() for pl in xf.placements]
    buf, slot, keep = local_map(
        functools.partial(_dispatch_local, n_experts=cfg.n_experts,
                          capacity=capacity),
        out_placements=(grp, grp, grp), in_placements=(grp, grp),
        device_mesh=mesh)(xf.redistribute(mesh, grp),
                          experts.redistribute(mesh, grp))
    buf = shard(buf, "moe_grp", "experts", None, None)
    out = shard(_expert_einsums(p, cfg, buf), "moe_grp", "experts", None,
                None)
    return local_map(_combine_local, out_placements=grp,
                     in_placements=(grp, grp, grp, grp), device_mesh=mesh)(
        out.redistribute(mesh, grp), slot, keep,
        weights.redistribute(mesh, grp))


def moe_mlp(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """(B, S, D) → (B, S, D), plus the router aux loss (f32 scalar)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    g = max(1, cfg.moe_groups)
    while t % g:                      # tiny smoke batches: shrink groups
        g //= 2
    tg = t // g
    capacity = int(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    xf = L.foldable(x).reshape(g, tg, d)

    weights, experts, aux = router(p, xf, cfg)
    aux = aux.mean()
    if isinstance(xf, DTensor):
        y = _moe_sharded(p, cfg, xf, weights, experts, capacity)
        return L.fold_grad(y.reshape(b, s, d).to(x.dtype)), aux
    slot, keep = capacity_dispatch(experts, e, capacity)
    rows = _buffer_rows(slot, capacity, g)                      # (g, tg·k)
    trash = e * g * capacity
    # every (token, k) pair's copy of its token, in (group, token, k) order
    src = xf[:, :, None, :].expand(g, tg, k, d).reshape(-1, d)
    buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, rows, trash).reshape(-1)] = src
    out = _expert_mlp(p, cfg, buf[:-1], g, capacity)

    gathered = out[rows.reshape(-1)] * (
        weights.reshape(-1, 1) * keep.reshape(-1, 1))
    y = gathered.view(g, tg, k, d).sum(2)     # a token's k rows, in order
    return y.reshape(b, s, d).to(x.dtype), aux
