"""Multi-pod dry run: trace every (arch × shape × mesh) step on fake ranks.

Port of ``repro.launch.dryrun``.  Proves the distribution config is
coherent without cards: a fake process group of the production world
size (``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``: every collective returns at once) forms the production
meshes (16×16 single-pod, 2×16×16 multi-pod) as DeviceMeshes.  The
parameters, AdamW moments, batch and decode cache are DTensors placed by
:mod:`repro_torch.launch.sharding` (``Model.param_specs``,
:func:`batch_logical`, :func:`cache_logical`), and the step (train with
AdamW and microbatching, prefill, or decode) runs once with DTensor
propagating the sharding op by op.  Every rank's local shard is a
``meta`` tensor: shapes and types, no storage, no data.  (Under
``FakeTensorMode`` DTensor's propagation of the attention's strided
splits reads a tensor's value and fails, so the shards are meta
tensors outside it, which allocate nothing either.)

The steps take the JAX package's arguments: train ``(params,
opt_state, batch)``, prefill ``(params, batch)`` (the cache is made in
the step), decode ``(params, cache, token, pos)`` with ``pos`` an int32
scalar; a step takes only the parameters it reads (:func:`read_params`),
as a jit keeps only those.

Per combo, per device (one rank's program), the dry run records:
  * trace wall time,
  * the JAX dry run's memory terms: argument, output and alias bytes of
    the traced step (local shards, exact), temp bytes from
    :func:`plan_memory` (arithmetic over the placements, no trace),
    ``total_bytes`` = argument + temp and the verdict ``fits_80gb``
    (an H100's 80 GB); and, as a diagnostic, the peak live bytes of
    DTensor's own layout of the step
    (``torch.distributed._tools.mem_tracker.MemTracker``,
    :data:`PEAK_NOTE`),
  * the collectives the step issues (kind, dtype, result shape and
    bytes, recorded on the fake group; the roofline's input),
  * FLOPs (``torch.utils.flop_counter``'s registry, the one
    ``FlopCounterMode`` reads, applied to the local ops) and bytes
    accessed, summed over the aten ops unfused (each op's inputs read
    and outputs written once; no fusion, so an upper bound),
  * the delta-method extrapolation (the step traced at 1 and 2 layer
    units; see :mod:`repro_torch.roofline.analysis`),
  * the three roofline terms and the dominant bottleneck.

A combo whose step DTensor cannot propagate is recorded
``{"ok": false, "error": …}`` and the run carries on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh single --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import (HBM_BYTES, PRODUCTION_SHAPES,
                                     make_production_mesh)
from repro_torch.launch.sharding import (_filter_rules, logical_to_pspec,
                                         mesh_shape, named_sharding,
                                         sharding_rules)
from repro_torch.models.layers import CHUNK_Q, CHUNK_Q_THRESHOLD
from repro_torch.models.model import Model
from repro_torch.roofline import analysis as RA
from repro_torch.train.optimizer import (AdamW, AdamWState, tree_leaves,
                                         tree_map)

#                 name          seq      global_batch  kind
SHAPES = {
    "train_4k":    (4_096,    256, "train"),
    "prefill_32k": (32_768,    32, "prefill"),
    "decode_32k":  (32_768,   128, "decode"),
    "long_500k":   (524_288,    1, "decode"),
}

SKIPS: dict[tuple[str, str], str] = {
    (a, "long_500k"): "pure full-attention (no SWA claimed by the source "
                      "model card) — quadratic attention cannot serve 500k"
    for a in ("grok-1-314b", "qwen3-moe-30b-a3b", "llava-next-34b")
}
SKIPS[("whisper-medium", "long_500k")] = (
    "enc-dec audio model; 500k-token decode is out of family scope")

BIG_OPT_THRESHOLD = 50e9   # params above this use bf16 AdamW moments
MICROBATCH_THRESHOLD = 20e9  # params above this gradient-accumulate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def n_micro_for(cfg: ArchConfig, shape_name: str) -> int:
    """Gradient-accumulation factor for the train shape: ≥100B models
    split the 1M-token global batch into 8 microbatches, ≥20B into 4."""
    if SHAPES[shape_name][2] != "train":
        return 1
    n = cfg.param_count()
    base = 16 if n > 200e9 else 8 if n > 30e9 else \
        4 if n > MICROBATCH_THRESHOLD else 2 if n > 6e9 else 1
    if cfg.remat_policy == "dots" and n > MICROBATCH_THRESHOLD:
        base *= 2          # dots-remat keeps more residents per microbatch
    return min(base, 16)


def delta_unit(cfg: ArchConfig) -> int:
    """Smallest repeatable layer pattern for the delta method."""
    if cfg.family == "ssm":
        return cfg.slstm_every
    if cfg.family == "hybrid":
        return cfg.attn_every
    return 1


def with_layers(cfg: ArchConfig, units: int, unroll: bool) -> ArchConfig:
    u = delta_unit(cfg)
    repl = dict(n_layers=u * units, unroll_layers=unroll)
    if cfg.family == "encdec":
        repl["enc_layers"] = units
    return dataclasses.replace(cfg, **repl)


def full_depth_units(cfg: ArchConfig) -> float:
    """Full depth measured in delta units (fractional for zamba's tail)."""
    return cfg.n_layers / delta_unit(cfg)


# ---------------------------------------------------------------------------
# input specs (shape/dtype stand-ins; nothing allocated)
# ---------------------------------------------------------------------------

class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    seq, batch, kind = SHAPES[shape_name]
    if kind in ("train", "prefill"):
        b = {"tokens": InputSpec((batch, seq), torch.int32)}
        if kind == "train":
            b["labels"] = InputSpec((batch, seq), torch.int32)
        if cfg.family == "encdec":
            b["frames"] = InputSpec((batch, cfg.n_frames, cfg.d_model),
                                    _DTYPES[cfg.dtype])
        if cfg.family == "vlm":
            b["patches"] = InputSpec((batch, cfg.n_image_tokens,
                                      cfg.d_model), _DTYPES[cfg.dtype])
        return b
    return {"token": InputSpec((batch, 1), torch.int32),
            "pos": InputSpec((), torch.int32)}


def batch_logical(cfg: ArchConfig, key: str) -> tuple:
    return {
        "tokens": ("batch", "seq"),
        "labels": ("batch", "seq"),
        "token": ("batch", None),
        "pos": (),
        "frames": ("batch", "frames", "embed"),
        "patches": ("batch", None, "embed"),
    }[key]


def cache_logical(key: str, ndim: int) -> tuple:
    if key in ("k", "v", "xk", "xv"):
        if ndim == 5:
            return (None, "batch", "kv_seq", "kv_heads", None)
    if key in ("m_c", "m_n"):        # (G, per, B, H, ...)
        return (None, None, "batch") + (None,) * (ndim - 3)
    if key.startswith("s_"):         # (G, B, H, pd)
        return (None, "batch") + (None,) * (ndim - 2)
    if key == "state":               # (G, k, B, H, P, N)
        return (None, None, "batch") + (None,) * (ndim - 3)
    if key == "tail_state":          # (T, B, H, P, N)
        return (None, "batch") + (None,) * (ndim - 2)
    return (None,) * ndim


def max_seq_for(cfg: ArchConfig, shape_name: str) -> int:
    seq, _, _ = SHAPES[shape_name]
    if cfg.family == "vlm":
        return seq + cfg.n_image_tokens
    return seq


# ---------------------------------------------------------------------------
# fake ranks, placed stand-ins, the recorder
# ---------------------------------------------------------------------------

def fake_mesh(shape: tuple, names: tuple):
    """A DeviceMesh of ``shape`` over a fake group of its world size (the
    default group is replaced if it has another size)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake group of its world size."""
    fake_mesh(*PRODUCTION_SHAPES[multi_pod])
    return make_production_mesh(multi_pod=multi_pod)


def placed(shape, dtype, logical, mesh):
    """A DTensor stand-in: global ``shape``, placed by the rules, its
    local shard a meta tensor."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    pl = named_sharding(shape, logical, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class StepRecorder(TorchDispatchMode):
    """One rank's step, op by op, on its local shards: the collectives it
    issues (a :class:`~repro_torch.roofline.analysis.Collective` each,
    sized by its result), its FLOPs (``torch.utils.flop_counter``'s
    registry, as ``FlopCounterMode`` counts them) and the bytes its aten
    ops access unfused (inputs read and outputs written once an op; views
    move nothing).  An op on DTensors is handed back to DTensor
    (``NotImplemented``), so the recorder sees the local ops and the
    collectives it lowers to, not the global op."""

    def __init__(self):
        super().__init__()
        self.collectives: list = []
        self.bytes_accessed = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) \
                and func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional", "c10d") \
                and name in _COLLECTIVE_KIND:
            res = out[0] if isinstance(out, (tuple, list)) else out
            while isinstance(res, (tuple, list)):
                res = res[0]
            if isinstance(res, torch.Tensor):
                self.collectives.append(RA.Collective(
                    "entry", _COLLECTIVE_KIND[name],
                    str(res.dtype).replace("torch.", ""),
                    tuple(res.shape), _nbytes(res)))
        elif not func.is_view and ns == "aten":
            flat = list(args) + list(kwargs.values())
            ins = [a for a in flat if isinstance(a, torch.Tensor)]
            ins += [x for a in flat if isinstance(a, (list, tuple))
                    for x in a if isinstance(x, torch.Tensor)]
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                _nbytes(o) for o in outs if isinstance(o, torch.Tensor))
        return out


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def mesh_config(cfg: ArchConfig, mesh) -> ArchConfig:
    """``cfg`` as a mesh runs it: the MoE family dispatches in one group a
    data-parallel shard, and ``expert_split`` -1 ("auto") resolves
    against the model axis."""
    if cfg.family != "moe":
        return cfg
    sizes = mesh_shape(mesh)
    cfg = dataclasses.replace(
        cfg, moe_groups=sizes.get("data", 1) * sizes.get("pod", 1))
    if cfg.expert_split == -1:
        cfg = dataclasses.replace(cfg, expert_split=max(
            1, sizes.get("model", 1) // cfg.n_experts))
    return cfg


def build(cfg: ArchConfig, shape_name: str, mesh, n_micro: int = 0):
    """Returns ``(step_fn, args)``: the step and its DTensor stand-ins.

    ``n_micro`` overrides the microbatch factor — the roofline's delta
    traces pass the *full-depth* config's factor (their 1–2-layer
    configs would otherwise resolve to 1)."""
    seq, batch, kind = SHAPES[shape_name]
    cfg = mesh_config(cfg, mesh)
    model = Model(cfg, device="meta")
    pdt = model.pdtype
    params = tree_map(lambda s, lg: placed(s, pdt, lg, mesh),
                      model.param_shapes(), model.param_specs())
    b = {k: placed(v.shape, v.dtype, batch_logical(cfg, k), mesh)
         for k, v in input_specs(cfg, shape_name).items()}

    if kind == "train":
        opt = AdamW(moment_dtype=("bfloat16" if cfg.param_count() >
                                  BIG_OPT_THRESHOLD else "float32"))
        mdt = _DTYPES[opt.moment_dtype]
        specs = model.param_specs()

        def moments():
            return tree_map(lambda p, lg: placed(p.shape, mdt, lg, mesh),
                            params, specs)
        opt_state = AdamWState(
            step=placed((), torch.int32, (), mesh), mu=moments(),
            nu=moments())
        for p in tree_leaves(params):
            p.requires_grad_(True)
        n_micro = n_micro or n_micro_for(cfg, shape_name)

        def grads_of(params, mb):
            leaves = tree_leaves(params)
            loss = model.loss(params, mb)
            gs = iter(torch.autograd.grad(loss, leaves))
            return loss, tree_map(lambda _p: next(gs), params)

        def step(params, opt_state, b):
            if n_micro == 1:
                loss, grads = grads_of(params, b)
            else:
                # microbatch i: rows i, i + n, i + 2n, … (a strided split
                # keeps the batch dimension's sharding, where the JAX
                # package's contiguous blocks would gather it)
                def micro(i):
                    return {k: v.unflatten(0, (v.shape[0] // n_micro,
                                               n_micro))[:, i]
                            for k, v in b.items()}
                if cfg.unroll_layers:
                    # delta traces measure ONE microbatch; the roofline
                    # scales by n_micro (see roofline_combo)
                    loss, grads = grads_of(params, micro(0))
                else:
                    loss, grads = grads_of(params, micro(0))
                    for i in range(1, n_micro):
                        li, gi = grads_of(params, micro(i))
                        grads = tree_map(torch.add, grads, gi)
                        loss = loss + li
                    grads = tree_map(lambda g: g / n_micro, grads)
                    loss = loss / n_micro
            new_params, new_opt = opt.update(grads, opt_state, params)
            return loss, new_params, new_opt

        return step, (params, opt_state, b)

    params = read_params(tree_map(lambda p: p.detach(), params), kind)
    ms = max_seq_for(cfg, shape_name)

    def cache_of(n: int) -> dict:
        return {k: placed(v.shape, v.dtype, cache_logical(k, v.dim()), mesh)
                for k, v in model.init_cache(n, ms).items()}
    if kind == "prefill":
        def step(params, b):
            # the cache is made here, as the JAX package's prefill makes
            # it, placed by cache_logical (a plain one for plain inputs)
            from torch.distributed.tensor import DTensor
            placed_in = isinstance(b["tokens"], DTensor)
            return model.prefill(params, b, ms,
                                 cache_of(batch) if placed_in else None)
        return step, (params, b)

    # decode: ``pos`` is an int32 scalar argument, as in the JAX package,
    # passed through to ``Model.decode_step``, which reads it on the
    # device.  xLSTM reads no position, and its step takes none (a jit
    # drops an argument its step never reads).
    def step(params, cache, token, pos=None):
        return model.decode_step(params, cache, token, pos)

    args = (params, cache_of(batch), b["token"])
    if cfg.family != "ssm":
        args += (b["pos"],)
    return step, args


# what a decode step never reads (the JAX package's jit drops these
# arguments: keep_unused=False): the vision projection, the encoder, and
# the cross-attention's K/V projections, whose products the cache holds
_DECODE_UNREAD = ("vis_proj", "enc_blocks", "enc_norm", "blocks.x_wk",
                  "blocks.x_wv")


def read_params(tree: dict, kind: str) -> dict:
    """``tree`` (the parameters, their shapes or their specs) without the
    leaves the ``kind`` step never reads."""
    if kind != "decode":
        return tree
    out = {}
    for g, v in tree.items():
        if g in _DECODE_UNREAD:
            continue
        if isinstance(v, dict):
            v = {k: x for k, x in v.items()
                 if f"{g}.{k}" not in _DECODE_UNREAD}
        out[g] = v
    return out


# ---------------------------------------------------------------------------
# the memory plan: arithmetic over the placements, no trace
# ---------------------------------------------------------------------------

class ShapeMesh(NamedTuple):
    """A mesh by its axis sizes alone (``{name: size}``, in mesh order):
    all the plan needs of one, so it runs with no process group."""
    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


class _Local:
    """Per-device bytes of a tensor placed by the rules on ``mesh``: its
    global size over the mesh axes its logical axes take (the rule
    engine's decisions, the divisibility fallback included)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.rules = _filter_rules(mesh, None)

    def __call__(self, shape, logical, dtype) -> int:
        n = math.prod(shape)
        for ax in logical_to_pspec(shape, logical, self.mesh, self.rules):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                n //= self.sizes[a]
        return n * dtype.itemsize

    def splits(self, dim: int, logical: str) -> bool:
        """True if ``logical`` takes mesh axes that divide ``dim``."""
        ax = self.rules.get(logical)
        size = math.prod(self.sizes[a] for a in
                         ((ax,) if isinstance(ax, str) else (ax or ())))
        return size > 1 and dim % size == 0


def _attention_terms(cfg, nb, b: int, sq: int, sk: int) -> int:
    """One attention sublayer's live tensors: q and its output, k and v
    repeated to the query heads (GQA), the f32 scores and the
    probabilities of a query chunk (``attend_auto`` chunks queries at 16k
    tokens and more)."""
    f32, dt = torch.float32, _DTYPES[cfg.dtype]
    h, hd = cfg.n_heads, cfg.hd
    seq_ax = "seq" if nb.splits(h, "heads") else "act_seq"
    q = nb((b, sq, h, hd), ("batch", seq_ax, "heads", "head_dim"), dt)
    # keys and values whole along the sequence on every rank
    k = nb((b, sk, h, hd), ("batch", None, "heads", "head_dim"), dt)
    cq = CHUNK_Q if sq >= CHUNK_Q_THRESHOLD else sq
    scores = (b, h, cq, sk), ("batch", "heads", "seq_model", None)
    return 2 * q + 2 * k + nb(*scores, f32) + nb(*scores, dt)


def _mlp_terms(cfg, nb, b: int, s: int, d_ff: int) -> int:
    """The MLP's hidden activations: gate, up and their product (or the
    input projection and its activation)."""
    seq_ax = "seq" if nb.splits(cfg.n_heads, "heads") else "act_seq"
    n = 3 if cfg.act == "silu" else 2
    return n * nb((b, s, d_ff), ("batch", seq_ax, "mlp"), _DTYPES[cfg.dtype])


def _moe_terms(cfg, nb, b: int, s: int) -> int:
    """The MoE layer's router probabilities (f32), the (g, E, C, D)
    dispatch buffer and expert output, the experts' hidden activations,
    and each (token, k) pair's row twice: its token's copy for the
    dispatch and its expert's output for the combine."""
    f32, dt = torch.float32, _DTYPES[cfg.dtype]
    t, e, k, d = b * s, cfg.n_experts, cfg.top_k, cfg.d_model
    g = max(1, cfg.moe_groups)
    while t % g:
        g //= 2
    tg = t // g
    c = int(tg * k / e * cfg.capacity_factor) + 1
    grp = ("moe_grp", None, None)
    buf = nb((g, e, c, d), ("moe_grp", "experts", None, None), dt)
    hid = nb((g, e, c, cfg.d_ff_expert), ("moe_grp", "experts", None, "mlp"),
             dt)
    return (2 * nb((g, tg, e), grp, f32) + 2 * buf
            + (3 if cfg.act == "silu" else 2) * hid
            + 2 * nb((g, tg * k, d), grp, dt))


def _mamba_terms(cfg, nb, b: int, s: int) -> int:
    """One Mamba2 (SSD) block: the input projection, the chunk decay and
    mixing matrices (f32), the chunk states (f32) and the gated output."""
    from repro_torch.models.ssm import CHUNK
    f32, dt = torch.float32, _DTYPES[cfg.dtype]
    h, p, n, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    nc = max(1, s // CHUNK)
    c = s // nc
    heads5 = ("batch", None, None, None, "ssm_heads")
    return (nb((b, s, 2 * di + 2 * n + h), ("batch", "seq", "ssm_inner"), dt)
            + 2 * nb((b, nc, c, c, h), heads5, f32)
            + 2 * nb((b, nc, h, p, n), ("batch", None, "ssm_heads", None,
                                        None), f32)
            + 2 * nb((b, s, h, p), ("batch", "seq", "ssm_inner", None), dt))


def _mlstm_terms(cfg, nb, b: int, s: int) -> int:
    """One mLSTM block: q, k, v, the chunk gate and score matrices (f32)
    and the chunk memory summaries (f32)."""
    from repro_torch.models.xlstm import CHUNK
    f32, dt = torch.float32, _DTYPES[cfg.dtype]
    h = cfg.n_heads
    p = cfg.d_inner // h
    nc = max(1, s // CHUNK)
    c = s // nc
    return (3 * nb((b, s, h, p), ("batch", "seq", None, "ssm_inner"), dt)
            + 3 * nb((b, nc, c, c, h), ("batch", None, None, None, None),
                     f32)
            + 2 * nb((b, nc, h, p, p), ("batch", None, None, "ssm_inner",
                                        None), f32))


def _slstm_terms(cfg, nb, b: int, s: int) -> int:
    """One sLSTM block: its input gates (4·D a token) and its per-step
    outputs."""
    dt = _DTYPES[cfg.dtype]
    return (nb((b, s, 4 * cfg.d_model), ("batch", "seq", None), dt)
            + nb((b, s, cfg.d_model), ("batch", "seq", None), dt))


def layer_terms(cfg: ArchConfig, nb, b: int, s: int) -> int:
    """The largest one-layer forward working set at (b, s) a device: the
    live intermediates of the family's largest block, besides its input
    and output."""
    if cfg.family == "ssm":
        return max(_mlstm_terms(cfg, nb, b, s), _slstm_terms(cfg, nb, b, s))
    attn = _attention_terms(cfg, nb, b, s, s)
    if cfg.family == "hybrid":
        return max(_mamba_terms(cfg, nb, b, s),
                   attn + _mlp_terms(cfg, nb, b, s, cfg.d_ff))
    if cfg.family == "moe":
        return max(attn, _moe_terms(cfg, nb, b, s))
    if cfg.family == "encdec":
        f = cfg.n_frames
        enc = _attention_terms(cfg, nb, b, f, f)
        cross = _attention_terms(cfg, nb, b, s, f)
        return max(enc, attn + cross) + _mlp_terms(cfg, nb, b, max(s, f),
                                                   cfg.d_ff)
    return max(attn, _mlp_terms(cfg, nb, b, s, cfg.d_ff))


def _decode_terms(cfg, nb, b: int, cache: dict) -> int:
    """One decode layer's working set: the f32 scores and probabilities
    against a cache layer, or a recurrent state's f32 update."""
    f32, dt = torch.float32, _DTYPES[cfg.dtype]
    if cfg.family == "ssm":
        h = cfg.n_heads
        p = cfg.d_inner // h
        return 3 * nb((b, h, p, p), ("batch", None, None, None), f32)
    w = cache["k"].shape[2]
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    sc = (b, kv, g, w), ("batch", "kv_heads", None, "kv_seq")
    terms = nb(*sc, f32) + nb(*sc, dt)
    if cfg.family == "hybrid":
        st = (b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        terms = max(terms, 3 * nb(st, ("batch", None, None, None), f32))
    return terms


def _n_blocks(cfg: ArchConfig) -> int:
    """Blocks a forward runs (zamba's shared attention once a group,
    whisper's encoder and decoder)."""
    if cfg.family == "hybrid":
        return cfg.n_layers + cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.n_layers + cfg.enc_layers
    return cfg.n_layers


def _saved_terms(cfg, nb, b: int, s: int) -> int:
    """Activations one microbatch's forward keeps for the backward, a
    block: its input under remat ``"full"``; also its matmul outputs
    under ``"dots"``; every intermediate without remat."""
    dt = _DTYPES[cfg.dtype]
    x = nb((b, s, cfg.d_model), ("batch", "act_seq", "embed"), dt)
    if not cfg.remat:
        return x + layer_terms(cfg, nb, b, s)
    if cfg.remat_policy == "dots":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        proj = (nb((b, s, (h + 2 * kv) * hd), ("batch", None, "heads"), dt)
                + 2 * x + _mlp_terms(cfg, nb, b, s, cfg.d_ff) * 2 // 3)
        return x + proj
    return x


def _gathered_layer(nb, shapes: dict, specs: dict, dtype) -> int:
    """The largest block's parameters gathered off the FSDP axis
    (``embed_fsdp``), as a matmul takes them: one layer of a stacked
    group, an unstacked group whole, the embedding or the LM head."""
    best = 0
    for g in shapes:
        leaves = list(zip(tree_leaves(shapes[g]), tree_leaves(specs[g])))
        stacked = all(len(sh) >= 2 and lg[0] is None for sh, lg in leaves) \
            and isinstance(shapes[g], dict)
        total = 0
        for sh, lg in leaves:
            lg = tuple(None if a == "embed_fsdp" else a for a in lg)
            total += nb(sh[1:], lg[1:], dtype) if stacked else \
                nb(sh, lg, dtype)
        best = max(best, total)
    return best


def _tree_bytes(nb, shapes: dict, specs: dict, dtype) -> int:
    return sum(nb(s, lg, dtype) for s, lg in
               zip(tree_leaves(shapes), tree_leaves(specs)))


def plan_memory(cfg: ArchConfig, shape_name: str, mesh) -> dict:
    """The per-device memory plan of the ``shape_name`` step on ``mesh``
    (a DeviceMesh or a :class:`ShapeMesh`), in the JAX package's terms,
    from the placements alone (``Model.param_specs``, the rules,
    :func:`batch_logical`, :func:`cache_logical`, :func:`n_micro_for`
    and the remat policy).  Bytes a device:

    * ``argument_bytes``: the parameters the step reads, AdamW's state
      (train), the batch, the cache and the position (decode);
    * ``output_bytes``: the loss and the updated parameters and state
      (train), the logits and the cache (prefill, decode);
    * ``alias_bytes``: the donated arguments the outputs take (train: the
      parameters and state; decode: the cache);
    * ``temp_bytes``: the sum of ``terms``, the step's buffers besides
      its arguments and outputs, as one program holds them: train — the
      gradients (and their accumulator under microbatching), AdamW's f32
      temporaries of one update slice, one microbatch's activations saved
      under the remat policy, the largest block's forward working set
      twice (its recomputed values and their gradients), its parameters
      gathered off the FSDP axis twice (forward and backward), the logits
      with the loss's f32 copies; prefill — the cache it writes, a
      block's working set, the residual stream, gathered parameters and
      the last logits; decode — the cache's double buffer (a functional
      step writes a new cache, as the JAX package's loop carries it; the
      port writes in place, so this is its upper bound), a layer's
      working set, gathered parameters and the logits;
    * ``total_bytes`` (argument + temp) and ``fits_80gb``.
    """
    seq, batch, kind = SHAPES[shape_name]
    cfg = mesh_config(cfg, mesh)
    nb = _Local(mesh)
    model = Model(cfg, device="meta")
    dt, f32 = model.dtype, torch.float32
    shapes = read_params(model.param_shapes(), kind)
    specs = read_params(model.param_specs(), kind)
    params = _tree_bytes(nb, shapes, specs, model.pdtype)
    args = params + sum(
        nb(v.shape, batch_logical(cfg, k), v.dtype)
        for k, v in input_specs(cfg, shape_name).items()
        if not (k == "pos" and cfg.family == "ssm"))
    b = batch                   # global shapes below: nb() places them
    terms = {}
    if kind == "train":
        mdt = f32 if cfg.param_count() <= BIG_OPT_THRESHOLD \
            else torch.bfloat16
        opt = 2 * _tree_bytes(nb, shapes, specs, mdt) + 4
        args += opt
        output = 4 + params + opt
        alias = params + opt
        n_micro = n_micro_for(cfg, shape_name)
        bm = b // n_micro
        s = seq + cfg.n_image_tokens if cfg.family == "vlm" else seq
        # AdamW updates a stacked leaf a layer at a time (four f32
        # temporaries: gradient, two moments, update)
        slices = [nb(sh[1:], lg[1:], f32) if len(sh) >= 3 and lg[0] is None
                  else nb(sh, lg, f32)
                  for sh, lg in zip(tree_leaves(shapes), tree_leaves(specs))]
        terms["gradients"] = params * (2 if n_micro > 1 else 1)
        terms["adamw"] = 4 * max(slices)
        terms["saved"] = _n_blocks(cfg) * _saved_terms(cfg, nb, bm, s)
        terms["block"] = 2 * layer_terms(cfg, nb, bm, s)
        terms["gathered"] = 2 * _gathered_layer(nb, shapes, specs,
                                                model.pdtype)
        # the logits, the f32 log-softmax, the gradient scattered into it
        # by the label gather, and the log-softmax's input gradient
        logits = (bm, seq, model.vpad), ("batch", "seq", "vocab")
        terms["logits"] = nb(*logits, dt) + 3 * nb(*logits, f32)
    else:
        cache = model.init_cache(batch, max_seq_for(cfg, shape_name))
        cache_b = {k: nb(v.shape, cache_logical(k, v.dim()), v.dtype)
                   for k, v in cache.items()}
        output = nb((batch, 1, model.vpad), ("batch", "seq", "vocab"),
                    dt) + sum(cache_b.values())
        alias = 0
        if kind == "prefill":
            s = seq + cfg.n_image_tokens if cfg.family == "vlm" else seq
            terms["cache"] = sum(cache_b.values())
            terms["block"] = layer_terms(cfg, nb, b, s)
            terms["residual"] = 2 * nb((b, s, cfg.d_model),
                                       ("batch", "act_seq", "embed"), dt)
        else:
            args += sum(cache_b.values())
            alias = sum(cache_b.values())
            terms["cache"] = sum(cache_b.values())
            terms["block"] = _decode_terms(cfg, nb, b, cache)
        terms["gathered"] = _gathered_layer(nb, shapes, specs,
                                            model.pdtype)
        logits = (b, 1, model.vpad), ("batch", "seq", "vocab")
        terms["logits"] = nb(*logits, dt) + nb(*logits, f32)
    temp = sum(terms.values())
    return {"argument_bytes": args, "output_bytes": output,
            "alias_bytes": alias, "temp_bytes": temp,
            "total_bytes": args + temp, "fits_80gb": args + temp <= HBM_BYTES,
            "terms": terms}


# what the recorded peak is, and why the verdict is not taken from it
PEAK_NOTE = ("peak live bytes of DTensor's layout of the port's step: "
             "where DTensor cannot split an op the port gathers its "
             "activations to Replicate (models/layers.py foldable, "
             "_attend_local), so this is not a sharded plan's peak and "
             "moves with the torch version's propagation rules; a "
             "diagnostic only: the fit verdict (fits_80gb) is the plan's")

# (argument, output) positions of the donated arguments and the outputs
# that take their buffers: train donates the parameters and AdamW state
# into the updated ones, decode the cache (the JAX package's
# donate_argnums); prefill donates nothing
DONATED = {"train": ((0, 1), (1, 2)), "decode": ((1, 1),), "prefill": ()}


def _run_step(step, args):
    """The step once under the recorders: (its outputs, the recorder, peak
    bytes), all of one rank."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    locals_ = [a.to_local() for a in _leaves(args)]
    mt = MemTracker()
    mt.track_external(*locals_)
    rec = StepRecorder()
    grad = any(a.requires_grad for a in _leaves(args))
    with torch.set_grad_enabled(grad), implicit_replication(), mt, rec:
        out = step(*args)
    peak = sum(v.get("Total", 0)
               for v in mt.get_tracker_snapshot("peak").values())
    return out, rec, peak


def _leaves(tree) -> list:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, DTensor) else []


def _local_bytes(tree) -> int:
    return sum(_nbytes(a.to_local()) for a in _leaves(tree))


def _alias_bytes(kind: str, args, out) -> int:
    """Bytes of the donated arguments whose buffers the outputs take: a
    donated leaf and the output leaf at its place in the tree, of one
    local shape and dtype (in the port the very tensor, updated in place,
    or the step counter's successor)."""
    total = 0
    for ai, oi in DONATED[kind]:
        for a, o in zip(_leaves(args[ai]), _leaves(out[oi])):
            a, o = a.to_local(), o.to_local()
            if a.shape == o.shape and a.dtype == o.dtype:
                total += _nbytes(a)
    return total


def compile_combo(cfg: ArchConfig, shape_name: str, mesh) -> dict:
    """Build the stand-ins and trace the step once; return its stats.

    ``memory`` holds the reference's terms, per device: argument, output
    and alias bytes of the traced step (local shards, exact), temp bytes
    from :func:`plan_memory`, ``total_bytes`` = argument + temp (as the
    JAX package defines it) and the verdict ``fits_80gb``; ``plan`` is
    the plan's own account, term by term."""
    t0 = time.time()
    kind = SHAPES[shape_name][2]
    plan = plan_memory(cfg, shape_name, mesh)
    with sharding_rules(mesh):
        step, args = build(cfg, shape_name, mesh)
        t_build = time.time() - t0
        out, rec, peak = _run_step(step, args)
    t_total = time.time() - t0
    arg_bytes = _local_bytes(args)
    coll = RA.collective_bytes(rec.collectives)
    total = arg_bytes + plan["temp_bytes"]
    return {
        "ok": True,
        "build_s": round(t_build, 1),
        "trace_s": round(t_total, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "output_leaf_bytes": [_nbytes(o.to_local())
                                  for o in _leaves(out)],
            "temp_bytes": plan["temp_bytes"],
            "alias_bytes": _alias_bytes(kind, args, out),
            "total_bytes": total,
            "fits_80gb": total <= HBM_BYTES,
            "peak_bytes": peak,
            "peak_note": PEAK_NOTE,
        },
        "plan": plan,
        "flops": rec.flops,
        "bytes_accessed": rec.bytes_accessed,
        "bytes_accessed_note": "summed over the aten ops, unfused",
        "collective_bytes": coll,
        "n_collectives": len(rec.collectives),
        "n_devices": mesh.size(),
    }


def roofline_combo(cfg: ArchConfig, shape_name: str, mesh,
                   coll_full: float = 0.0) -> dict:
    """Delta-method FLOPs/bytes + roofline terms.

    ``coll_full`` — collective bytes recorded by the *full-depth* trace;
    preferred over the delta extrapolation, as in the JAX package."""
    seq, batch, _ = SHAPES[shape_name]
    vals = {}
    nm_full = n_micro_for(cfg, shape_name)
    for units in (1, 2):
        dcfg = with_layers(cfg, units, unroll=True)
        with sharding_rules(mesh):
            step, args = build(dcfg, shape_name, mesh, n_micro=nm_full)
            _, rec, _ = _run_step(step, args)
        coll = RA.collective_bytes(rec.collectives)
        vals[units] = (rec.flops, rec.bytes_accessed, coll["total"])
    lf = full_depth_units(cfg)
    nm = n_micro_for(cfg, shape_name)
    flops = RA.extrapolate(vals[1][0], vals[2][0], 1, 2, lf) * nm
    hbm = RA.extrapolate(vals[1][1], vals[2][1], 1, 2, lf) * nm
    coll_delta = RA.extrapolate(vals[1][2], vals[2][2], 1, 2, lf) * nm
    coll_b = coll_full if coll_full > 0 else coll_delta
    terms = RA.RooflineTerms.build(flops, hbm, coll_b)
    mf_global = RA.model_flops(cfg, shape_name, seq, batch)
    mf_per_dev = mf_global / mesh.size()
    return {
        "delta_units": {str(k): v for k, v in vals.items()},
        "collective_bytes_delta": coll_delta,
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "collective_bytes_per_device": coll_b,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "bottleneck": terms.bottleneck,
        "model_flops_per_device": mf_per_dev,
        "model_vs_traced_flops": (mf_per_dev / flops) if flops else None,
        "collective_note": RA.COLLECTIVE_NOTE,
    }


def variant_for(cfg: ArchConfig, shape: str,
                opt: bool = False) -> ArchConfig:
    """long_500k on attention archs runs the sliding-window serving
    variant (sub-quadratic; window-sized ring cache).  ``opt`` enables
    the beyond-paper optimizations."""
    if shape == "long_500k" and cfg.long_context_window:
        cfg = dataclasses.replace(cfg,
                                  sliding_window=cfg.long_context_window)
    if opt and SHAPES[shape][2] == "decode":
        cfg = dataclasses.replace(cfg, opt_decode=True)
    if opt and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, expert_split=-1)  # auto vs mesh
    if opt and SHAPES[shape][2] == "train":
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    return cfg


def run(arch: str, shape: str, meshes: list[str], out_dir: str,
        do_roofline: bool, opt: bool = False) -> dict:
    cfg = variant_for(ARCHS[arch], shape, opt=opt)
    result = {"arch": arch, "shape": shape, "opt": opt}
    if (arch, shape) in SKIPS:
        result["skipped"] = SKIPS[(arch, shape)]
        print(f"[skip] {arch} × {shape}: {result['skipped']}")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result
    for mesh_kind in meshes:
        key = f"mesh_{mesh_kind}"
        try:
            mesh = production_mesh(multi_pod=(mesh_kind == "multi"))
            result[key] = compile_combo(cfg, shape, mesh)
            m = result[key]["memory"]
            fit = "fits" if m["fits_80gb"] else "does NOT fit"
            print(f"[ok]   {arch} × {shape} × {mesh_kind}: "
                  f"trace {result[key]['trace_s']}s, "
                  f"args {m['argument_bytes'] / 1e9:.2f} GB, "
                  f"temps {m['temp_bytes'] / 1e9:.2f} GB/device "
                  f"({fit} 80 GB), "
                  f"coll {result[key]['collective_bytes']['total'] / 1e9:.2f}"
                  f" GB")
        except Exception as e:  # noqa: BLE001 — record and continue
            result[key] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {arch} × {shape} × {mesh_kind}: "
                  f"{str(e)[-300:]}")
    if do_roofline and "single" in meshes and \
            result.get("mesh_single", {}).get("ok"):
        try:
            mesh = production_mesh(multi_pod=False)
            coll_full = result["mesh_single"]["collective_bytes"]["total"]
            result["roofline"] = roofline_combo(cfg, shape, mesh,
                                                coll_full=coll_full)
            r = result["roofline"]
            print(f"       roofline: compute {r['compute_s'] * 1e3:.2f} ms, "
                  f"memory {r['memory_s'] * 1e3:.2f} ms, "
                  f"collective {r['collective_s'] * 1e3:.2f} ms "
                  f"→ {r['bottleneck']}-bound")
        except Exception as e:  # noqa: BLE001
            result["roofline"] = {"error": f"{type(e).__name__}: {e}",
                                  "traceback":
                                      traceback.format_exc()[-2000:]}
            print(f"[FAIL] roofline {arch} × {shape}: {str(e)[-300:]}")
    os.makedirs(out_dir, exist_ok=True)
    suffix = "__opt" if opt else ""
    path = os.path.join(out_dir, f"{arch}__{shape}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch name or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="enable beyond-paper §Perf optimizations")
    args = ap.parse_args()

    archs = sorted(ARCHS) if args.arch == "all" or args.all \
        else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" or args.all \
        else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            r = run(arch, shape, meshes, args.out,
                    do_roofline=not args.no_roofline, opt=args.opt)
            for v in r.values():
                if isinstance(v, dict) and v.get("ok") is False:
                    n_fail += 1
    print(f"\ndone; {n_fail} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
