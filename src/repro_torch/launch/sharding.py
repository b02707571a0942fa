"""Logical-axis sharding with divisibility fallback.

Port of ``repro.launch.sharding``.  Model code names the axes of a
tensor logically (``"batch"``, ``"heads"``, ``"mlp"``, …); a rule table
maps each logical axis to mesh axes, and :func:`logical_to_pspec` drops
any mapping whose mesh-axis product does not divide the tensor dimension
(llava's 56 heads on a 16-way model axis), or that reuses a mesh axis an
earlier dimension took, or that names an axis the mesh lacks: that
dimension is then replicated.  Outside a rules context every annotation
is a no-op.

The decisions are the JAX package's.  Their result is a per-dimension
assignment of mesh axes (a tuple with one entry a dimension: ``None``, a
mesh-axis name, or a tuple of names, as a ``PartitionSpec`` holds them);
:func:`placements` turns one into DTensor placements over a
:class:`~torch.distributed.device_mesh.DeviceMesh` (``named_sharding``'s
counterpart).  The engine takes a shape-only mesh as well (``.shape`` a
dict, ``.axis_names``), as the JAX tests' stand-in is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

Axes = Union[str, tuple, None]

_state = threading.local()


DEFAULT_RULES: dict[str, Axes] = {
    # data-parallel axes
    "batch": ("pod", "data"),
    "fleet": ("pod", "data"),
    # tensor-parallel axes
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",
    # SSD/mLSTM chunk intermediates: heads (zamba: 112 % 16 = 0) or the
    # per-head dim P (xlstm: P=1024) take the model axis
    "ssm_heads": "model",
    # MoE dispatch-buffer capacity dim: data-parallel when experts cannot
    # take the model axis (grok: 8 experts < 16-way model axis)
    "moe_cap": "data",
    # MoE dispatch-group dim = data-parallel shards (group-wise dispatch)
    "moe_grp": ("pod", "data"),
    # fallback tensor-parallel axis for big attention intermediates when
    # heads are not divisible by the model axis (llava 56H, starcoder2 24H)
    "seq_model": "model",
    # decode KV cache sequence dim: always divisible (32k / 8k windows),
    # unlike kv_heads (usually 8 < 16-way model axis) — flash-decode style
    "kv_seq": "model",
    # fsdp: parameters' embed dim sharded over the data axis
    "embed_fsdp": "data",
    # residual-stream sequence parallelism over 'model'
    "act_seq": "model",
    # unsharded by default
    "seq": None,
    "embed": None,
    "head_dim": None,
    "state": None,
    "frames": None,
}


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a DeviceMesh's ``mesh_dim_names`` or a
    shape-only mesh's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a shape-only mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def _filter_rules(mesh, rules: Optional[dict]) -> dict:
    """DEFAULT_RULES updated by ``rules``, with the mesh axes the mesh does
    not have dropped (e.g. ``"pod"`` on a 2-D mesh)."""
    names = axis_names(mesh)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)

    def filter_axes(ax: Axes) -> Axes:
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        kept = tuple(a for a in ax if a in names)
        return kept or None
    return {k: filter_axes(v) for k, v in merged.items()}


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[dict[str, Axes]] = None):
    """Activate logical-axis rules (and the mesh) for the model code."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, _filter_rules(mesh, rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def _axis_size(shape: dict, ax: Axes) -> int:
    if ax is None:
        return 1
    if isinstance(ax, str):
        return shape[ax]
    size = 1
    for a in ax:
        size *= shape[a]
    return size


def logical_to_pspec(shape: Sequence[int], logical: Sequence[Optional[str]],
                     mesh=None, rules: Optional[dict[str, Axes]] = None
                     ) -> tuple:
    """The mesh axes of each dimension (``None`` = replicated), with the
    divisibility fallback; ``()`` outside a rules context when no mesh and
    rules are given."""
    ctx = getattr(_state, "ctx", None)
    if mesh is None or rules is None:
        if ctx is None:
            return ()
        mesh = mesh or ctx[0]
        rules = rules or ctx[1]
    sizes = mesh_shape(mesh)
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical):
        ax = rules.get(name) if name else None
        size = _axis_size(sizes, ax)
        flat = (ax,) if isinstance(ax, str) else (ax or ())
        if ax is None or size == 1 or dim % size != 0 or \
                any(a in used for a in flat):
            parts.append(None)
        else:
            # a one-axis tuple reads as the axis, as a PartitionSpec
            # normalises it
            parts.append(flat[0] if len(flat) == 1 else ax)
            used.update(flat)
    return tuple(parts)


def placements(spec: Sequence[Axes], mesh) -> list:
    """DTensor placements over ``mesh`` for a per-dimension assignment:
    a mesh dimension that some tensor dimension names is ``Shard`` of it
    (two mesh axes on one dimension split it major-to-minor in mesh
    order, as a ``PartitionSpec`` tuple does), every other one
    ``Replicate``."""

    out = [Replicate() for _ in axis_names(mesh)]
    index = {a: i for i, a in enumerate(axis_names(mesh))}
    for dim, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            out[index[a]] = Shard(dim)
    return out


def resolves(dim: int, logical: str) -> bool:
    """True if ``logical`` maps to mesh axes whose product divides dim
    under the active rules (False outside a rules context)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return False
    mesh, rules = ctx
    size = _axis_size(mesh_shape(mesh), rules.get(logical))
    return size > 1 and dim % size == 0


def named_sharding(shape: Sequence[int], logical: Sequence[Optional[str]],
                   mesh, rules: Optional[dict[str, Axes]] = None) -> list:
    """The DTensor placements of a tensor of ``shape`` with ``logical``
    axes on ``mesh`` under DEFAULT_RULES updated by ``rules``."""
    spec = logical_to_pspec(shape, logical, mesh, _filter_rules(mesh, rules))
    return placements(spec, mesh)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: a DTensor under active
    rules is redistributed to their placements; anything else (a plain
    tensor, or no rules) passes through untouched."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(logical_to_pspec(x.shape, logical, mesh, rules), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
