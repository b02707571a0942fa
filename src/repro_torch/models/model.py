"""Model assembly: the ``dense``, ``vlm``, ``moe``, ``encdec`` (whisper),
``ssm`` (xLSTM) and ``hybrid`` (Zamba2) families.

Port of ``repro.models.model``.  One :class:`Model` per
:class:`~repro_torch.configs.base.ArchConfig` exposes:

* ``init(generator)``          → parameter dict (blocks stacked per layer)
* ``forward(params, batch)``   → (logits, aux), full sequence
* ``loss(params, batch)``      → scalar LM loss (+ the moe router aux)
* ``init_cache(batch, max_seq)`` → decode cache dict
* ``prefill(params, batch, max_seq)`` → (last logits, cache)
* ``decode_step(params, cache, token, pos)`` → (logits, cache)

and :class:`DecodeProgram` is the decode step as one program, the
counterpart of ``jax.jit(model.decode_step)``: one CUDA graph on the
card, replayed at every position.  :class:`PrefillProgram` is the
prefill's, one CUDA graph a prompt shape, writing into a
``DecodeProgram``'s cache: a served request is two replays.

Parameters keep the JAX package's tree (``params_from_numpy`` in
:mod:`repro_torch.convert` carries a JAX ``Model.init`` tree across), and
layers run as a Python loop over the stacked per-layer tensors in place
of ``lax.scan``.  ``cfg.attn_impl == "kernel"`` sends every op of the
path that has a hand kernel through it: ``forward``'s attention through
the flash-attention kernel, ``decode_step``'s through the flash-decode
kernel (contiguous caches only), every RMSNorm through the fused RMSNorm
kernel, the hybrid family's Mamba2 scans in ``forward`` and ``prefill``
through the selective-scan kernel, and the moe family's expert products
(in ``forward``, ``prefill`` and ``decode_step``) through the grouped-GEMM
kernel.  ``prefill``'s attention is plain in either case, as the JAX
package's is; the hybrid's decode update has no kernel, as in the JAX
package.  The encdec family's encoder (non-causal blocks over
``batch["frames"]``) takes the flash kernel in ``forward`` and
``prefill``; its cross-attention is plain on every route, and its
decoder self-attention decodes through flash decode, as in the JAX
package.  ``forward`` returns the moe family's router aux loss summed
over layers as ``aux`` (zero for the other families).

The kernel route is forward-only (``kernels/ops.py``), as the JAX
package's ``"pallas"`` route is: ``loss`` is differentiated on ``"ref"``.
With ``cfg.remat``, a block whose parameters or input require grad is
recomputed in the backward pass (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``); it changes no number, and a forward
that needs no gradient (a served one) runs its blocks directly.  Policy
``"full"`` saves nothing of the block; ``"dots"`` (selective
checkpointing) saves the outputs of the matmuls that have no batch
dimension, ``aten.mm`` and ``aten.addmm``, and recomputes the rest.  In
the port those are the products written with ``@`` on a weight matrix
(PyTorch folds the leading dimensions of ``x @ w`` into one ``mm``): the
q/k/v projections (:func:`~repro_torch.models.layers.project`, whisper's
cross ones too), the dense MLP's ``wg``/``wu``/``wi``/``wd``, the router,
the Mamba2 and xLSTM projections and the vlm's ``vis_proj``.  The
``einsum`` products lower to ``aten.bmm`` (with a batch of 1 for a
weight) and are recomputed: the output projection ``wo``, the attention
scores and values, the expert einsums and the unembedding.  The JAX
policy saves ``wo``'s product and the unembedding too.

``param_specs()`` gives every parameter's logical axes
(:mod:`repro_torch.launch.sharding` places them on a mesh).  With
``cfg.opt_decode`` and a mesh active (``sharding_rules``), a decode step's
self-attention runs :func:`~repro_torch.models.layers.
decode_update_attend_sharded`: the cache's sequence split over the
``"model"`` ranks, partial softmaxes combined by all-reduces.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device, warm_and_capture
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch.sharding import current_mesh, shard
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}



# ---------------------------------------------------------------------------
# parameter tables:  name → (shape, logical axes)
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ArchConfig, prefix: str = "") -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": ((d, h, hd), ("embed_fsdp", "heads", "head_dim")),
         "wk": ((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
         "wv": ((d, kv, hd), ("embed_fsdp", "kv_heads", "head_dim")),
         "wo": ((h, hd, d), ("heads", "head_dim", "embed_fsdp"))}
    if cfg.qkv_bias:
        p.update({"bq": ((h, hd), ("heads", "head_dim")),
                  "bk": ((kv, hd), ("kv_heads", "head_dim")),
                  "bv": ((kv, hd), ("kv_heads", "head_dim"))})
    return {prefix + name: v for name, v in p.items()}


def _mlp_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"wg": ((d, f), ("embed_fsdp", "mlp")),
                "wu": ((d, f), ("embed_fsdp", "mlp")),
                "wd": ((f, d), ("mlp", "embed_fsdp"))}
    return {"wi": ((d, f), ("embed_fsdp", "mlp")),
            "wd": ((f, d), ("mlp", "embed_fsdp"))}


def _norm_def(d: int) -> tuple:
    return (d,), (None,)


def _dense_block_defs(cfg: ArchConfig) -> dict:
    return {"ln1": _norm_def(cfg.d_model), "ln2": _norm_def(cfg.d_model),
            **_attn_defs(cfg), **_mlp_defs(cfg)}


def _moe_block_defs(cfg: ArchConfig) -> dict:
    """The moe block; with ``expert_split`` s > 1 the experts take the
    split layout, ``(E·s, D, Fe/s)`` up and ``(E·s, Fe/s, D)`` down, the
    merged expert dimension on the model axis."""
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"ln1": _norm_def(d), "ln2": _norm_def(d), **_attn_defs(cfg),
         "router": ((d, e), ("embed_fsdp", "experts"))}
    sp = max(cfg.expert_split, 1)
    e2, f2 = e * sp, fe // sp
    up = ((e2, d, f2), ("experts", "embed_fsdp", "mlp"))
    if cfg.act == "silu":
        p.update({"we_g": up, "we_u": up})
    else:
        p["we_i"] = up
    p["we_d"] = ((e2, f2, d), ("experts", "mlp", "embed_fsdp"))
    return p


def _mamba_block_defs(cfg: ArchConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"ln": _norm_def(d),
            "w_in": ((d, 2 * di + 2 * n + h), ("embed_fsdp", "ssm_inner")),
            "dt_bias": ((h,), (None,)), "a_log": ((h,), (None,)),
            "d_skip": ((h,), (None,)),
            "w_out": ((di, d), ("ssm_inner", "embed_fsdp"))}


def _mlstm_block_defs(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    return {"ln": _norm_def(d),
            "wq": ((d, di), ("embed_fsdp", "ssm_inner")),
            "wk": ((d, di), ("embed_fsdp", "ssm_inner")),
            "wv": ((d, di), ("embed_fsdp", "ssm_inner")),
            "w_gate": ((d, 2 * cfg.n_heads), ("embed_fsdp", None)),
            "w_out": ((di, d), ("ssm_inner", "embed_fsdp"))}


def _slstm_block_defs(cfg: ArchConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    pd = d // h
    return {"ln": _norm_def(d), "w_in": ((d, d), ("embed_fsdp", None)),
            "w_rec": ((h, 2 * pd, 4 * pd), ("heads", None, None)),
            "b_rec": ((h, 4 * pd), ("heads", None)),
            "w_out": ((d, d), (None, "embed_fsdp"))}


def _encdec_dec_defs(cfg: ArchConfig) -> dict:
    """A whisper decoder block: self-attention, cross-attention (the
    ``x_`` projections) and the MLP, each behind its own norm."""
    return {"ln1": _norm_def(cfg.d_model), "ln2": _norm_def(cfg.d_model),
            "ln3": _norm_def(cfg.d_model), **_attn_defs(cfg),
            **_attn_defs(cfg, prefix="x_"), **_mlp_defs(cfg)}


def init_constant(name: str):
    """The constant a parameter starts at in the JAX ``Model.init`` scheme
    (1 for norms and D skips, 0 for biases and ``a_log``), or None for a
    matrix drawn at random.  The reference's rule matches names only, so
    the encdec family's ``enc_norm.scale`` is drawn at random, as there."""
    if name.startswith(("ln", "d_skip")):
        return 1.0
    if name in ("dt_bias", "a_log") or name.startswith("b"):
        return 0.0
    return None


# matmuls with no batch dimension, whose outputs remat "dots" saves (the
# counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of ``aten.mm`` and ``aten.addmm``, recompute every
    other op (``aten.bmm`` included)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _write_rows(layer, slots, rows, s: int) -> None:
    """``layer[:, slots] = rows`` in place: a prompt of ``s`` tokens' last
    rows into a cache layer (B, W, …), at its first slots or (a ring's
    index tensor) at slot p % W for position p.  A DTensor layer is built
    out of place and copied back, from a concatenation and a ``where``:
    DTensor keeps no placement through an in-place write into its split,
    and torch 2.11's has no rule for ``index_copy``."""
    if not isinstance(layer, DTensor):
        layer[:, slots] = rows
        return
    w, take = layer.shape[1], rows.shape[1]
    if take < w:                 # the first slots (p % W = p while s ≤ W)
        pad = rows.new_zeros((rows.shape[0], w - take, *rows.shape[2:]))
        first = torch.arange(w, device=rows.device) < take
        rows = torch.where(first[:, None, None],
                           torch.cat([rows, pad], 1), layer)
    elif not isinstance(slots, slice) and s % w:
        r = s % w                # slot j holds row (j − s) mod W
        rows = torch.cat([rows[:, w - r:], rows[:, :w - r]], 1)
    layer.copy_(rows)


def _layer(stacked: dict, i: int) -> dict:
    return {name: t[i] for name, t in stacked.items()}


class Model:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family == "moe":
            MOE.check_expert_split(cfg)
        if cfg.attn_impl not in ("ref", "kernel"):
            raise ValueError(f"attn_impl {cfg.attn_impl!r}: want 'ref' or "
                             f"'kernel'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.pdtype = _DTYPES[cfg.param_dtype]
        # embedding / lm-head padded to a multiple of 256; the pad logits
        # are masked to -1e30 in unembed() so they never win
        self.vpad = -(-cfg.vocab // 256) * 256

    # -- structure ------------------------------------------------------
    def _groups(self) -> dict:
        """{group name: (name → (per-layer shape, logical axes), stack
        count or None)}."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm"):
            lay = {"blocks": (_dense_block_defs(cfg), cfg.n_layers)}
            if cfg.family == "vlm":
                lay["vis_proj"] = ({"w": ((cfg.d_model, cfg.d_model),
                                          ("embed_fsdp", None))}, None)
            return lay
        if cfg.family == "moe":
            return {"blocks": (_moe_block_defs(cfg), cfg.n_layers)}
        if cfg.family == "encdec":       # whisper
            return {"enc_blocks": (_dense_block_defs(cfg), cfg.enc_layers),
                    "enc_norm": ({"scale": _norm_def(cfg.d_model)}, None),
                    "blocks": (_encdec_dec_defs(cfg), cfg.n_layers)}
        if cfg.family == "hybrid":       # Zamba2
            g, tail = self._zamba_groups()
            lay = {"mamba": (_mamba_block_defs(cfg), g * cfg.attn_every),
                   "shared_attn": (_dense_block_defs(cfg), None)}
            if tail:
                lay["mamba_tail"] = (_mamba_block_defs(cfg), tail)
            return lay
        g, rem = divmod(cfg.n_layers, cfg.slstm_every)
        if rem:
            raise ValueError(f"{cfg.name}: xlstm layers ({cfg.n_layers}) "
                             f"must be a multiple of slstm_every "
                             f"({cfg.slstm_every})")
        return {"mlstm": (_mlstm_block_defs(cfg), g * (cfg.slstm_every - 1)),
                "slstm": (_slstm_block_defs(cfg), g)}

    def layout(self) -> dict:
        """{group name: (name → per-layer shape, stack count or None)}."""
        return {group: ({k: shape for k, (shape, _) in defs.items()}, n)
                for group, (defs, n) in self._groups().items()}

    def param_specs(self) -> dict:
        """The logical axes of every parameter, in :meth:`init`'s tree: the
        JAX package's ``Model.param_specs``, a stacked leaf led by
        ``None`` (its layer axis)."""
        specs = {"embed": ("vocab", "embed_fsdp"), "final_norm": (None,)}
        if not self.cfg.tie_embeddings:
            specs["lm_head"] = ("embed_fsdp", "vocab")
        for group, (defs, n) in self._groups().items():
            specs[group] = {k: ((None, *ax) if n is not None else ax)
                            for k, (_, ax) in defs.items()}
        return specs

    def param_shapes(self) -> dict:
        """The parameter tree's shapes, as :meth:`init` builds it."""
        cfg = self.cfg
        shapes = {"embed": (self.vpad, cfg.d_model),
                  "final_norm": (cfg.d_model,)}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (cfg.d_model, self.vpad)
        for name, (defs, n) in self.layout().items():
            shapes[name] = {k: ((n, *s) if n else s) for k, s in defs.items()}
        return shapes

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters from ``generator`` (on this model's device):
        N(0, 1)/sqrt(fan_in) matrices, unit norms and D skips, zero biases
        (``dt_bias`` too) and ``a_log`` (A = −1 a head), an N(0, 0.02²)
        embedding — the JAX ``Model.init`` scheme, not its numbers (the
        two generators differ)."""
        cfg, dev = self.cfg, self.device

        def normal(shape, std):
            return (torch.randn(shape, generator=generator, device=dev)
                    * std).to(self.pdtype)

        params = {"embed": normal((self.vpad, cfg.d_model), 0.02),
                  "final_norm": torch.ones(cfg.d_model, dtype=self.pdtype,
                                           device=dev)}
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((cfg.d_model, self.vpad),
                                       1.0 / math.sqrt(cfg.d_model))
        for group, (defs, n) in sorted(self.layout().items()):
            out = {}
            for name, shape in sorted(defs.items()):
                full = (n, *shape) if n else shape
                const = init_constant(name)
                if const is not None:
                    out[name] = torch.full(full, const, dtype=self.pdtype,
                                           device=dev)
                else:
                    fan_in = math.prod(shape[:-1]) if len(shape) > 1 \
                        else shape[0]
                    std = 1.0 / math.sqrt(fan_in)
                    # one layer at a time: no f32 copy of the whole stack
                    t = torch.empty(full, dtype=self.pdtype, device=dev)
                    for i in range(n or 1):
                        (t[i] if n else t).copy_(normal(shape, std))
                    out[name] = t
            params[group] = out
        return params

    # -- shared pieces ---------------------------------------------------
    def _norm(self, x, scale):
        """RMSNorm on ``cfg.attn_impl``'s route (the kernel or plain)."""
        return L.rms_norm(x, scale, self.cfg.norm_eps, self.cfg.attn_impl)

    def _ffn(self, p, x):
        """The block's feed-forward on normed x: the moe family's experts
        (their aux dropped, as the JAX package's prefill and decode drop
        it) or the dense MLP."""
        if self.cfg.family == "moe":
            return MOE.moe_mlp(p, self.cfg, x)[0]
        return L.mlp(p, self.cfg, x)

    def _block(self, fn, p: dict, x, *rest):
        """``fn(p, x, *rest)``, one block; under ``cfg.remat`` recomputed
        in the backward pass when its parameters or input require grad
        (a forward that takes no gradient runs it directly)."""
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled() and (
                x.requires_grad or any(t.requires_grad for t in p.values()))):
            return fn(p, x, *rest)
        if cfg.remat_policy == "full":
            return checkpoint(fn, p, x, *rest, use_reentrant=False)
        if cfg.remat_policy == "dots":
            return checkpoint(fn, p, x, *rest, use_reentrant=False,
                              context_fn=_dots_contexts)
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r}: "
                         f"want 'full' or 'dots'")

    def _dense_block(self, p, x, causal: bool = True, window=None):
        cfg = self.cfg
        h = L.attention_block(p, cfg, self._norm(x, p["ln1"]),
                              causal=causal, window=window)
        x = x + h
        x = x + L.mlp(p, cfg, self._norm(x, p["ln2"]))
        return shard(x, "batch", "act_seq", "embed")

    def _encoder_block(self, p, x):
        """A whisper encoder block: non-causal, no band."""
        return self._dense_block(p, x, causal=False, window=0)

    def _decdec_block(self, p, x, enc):
        """A whisper decoder block: causal self-attention, cross-attention
        to the encoder's output ``enc``, the MLP."""
        cfg = self.cfg
        x = x + L.attention_block(p, cfg, self._norm(x, p["ln1"]))
        x = x + self._cross_attend(p, self._norm(x, p["ln2"]),
                                   *self._cross_kv(p, enc))
        return x + L.mlp(p, cfg, self._norm(x, p["ln3"]))

    def _cross_kv(self, p, enc):
        """The cross-attention's K/V of the encoder's output ``enc``."""
        return L.project(enc, p["x_wk"]), L.project(enc, p["x_wv"])

    def _cross_attend(self, p, x, k, v):
        """Cross-attention of normed x to the encoder's K/V: plain on
        every route, as in the JAX package."""
        q = L.project(x, p["x_wq"])
        out = L.attend(q, k, v, causal=False, window=0)
        return L.fold_grad(torch.einsum("bshk,hkd->bsd", out, p["x_wo"]))

    def _encode(self, params, frames):
        """The encoder over the stub frontend's ``frames`` (B, F, D),
        then ``enc_norm``."""
        x = frames.to(self.dtype)
        for i in range(self.cfg.enc_layers):
            x = self._block(self._encoder_block,
                            _layer(params["enc_blocks"], i), x)
        return self._norm(x, params["enc_norm"]["scale"])

    def _moe_block(self, p, x):
        """Pre-norm attention + MoE block; returns (x + y, router aux)."""
        h = L.attention_block(p, self.cfg, self._norm(x, p["ln1"]))
        x = x + h
        y, aux = MOE.moe_mlp(p, self.cfg, self._norm(x, p["ln2"]))
        return shard(x + y, "batch", "act_seq", "embed"), aux

    def _mamba_block(self, p, x):
        """Pre-norm Mamba2 block from a zero state; returns (x + y, final
        state)."""
        y, state = SSM.ssd_block(p, self.cfg, self._norm(x, p["ln"]))
        return x + y, state

    def embed_tokens(self, params, tokens):
        # the embedding op, not an indexing: the same gather, and DTensor
        # shards it and its backward (an indexing's scatter-add backward
        # it does not)
        w = params["embed"]
        if isinstance(w, DTensor):
            # the table's width gathered off its split (embed_fsdp), as
            # FSDP gathers a parameter it is about to use: DTensor's
            # masked lookup over the vocab split cannot take tokens split
            # along a mesh axis that also splits the width
            w = w.redistribute(w.device_mesh, [
                Replicate() if p.is_shard(1) else p for p in w.placements])
        x = F.embedding(tokens, w)
        return shard(x.to(self.dtype), "batch", "act_seq", "embed")

    def unembed(self, params, x):
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].T
        logits = L.fold_grad(torch.einsum("bsd,dv->bsv", L.foldable(x),
                                          w.to(self.dtype)))
        logits = shard(logits, "batch", "seq", "vocab")
        if self.vpad != self.cfg.vocab:      # mask padding columns
            keep = torch.arange(self.vpad, device=x.device) < self.cfg.vocab
            logits = torch.where(keep, logits, L.NEG)
        return logits

    def _embed_inputs(self, params, batch):
        x = self.embed_tokens(params, batch["tokens"])
        if self.cfg.family == "vlm":
            img = batch["patches"].to(self.dtype) @ params["vis_proj"]["w"]
            x = torch.cat([img, x], dim=1)
        return x

    # -- forward ------------------------------------------------------------
    def forward(self, params, batch):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "ssm":
            x = self._xlstm_forward(params, batch)
        elif cfg.family == "hybrid":
            x = self._zamba_forward(params, batch)
        elif cfg.family == "moe":
            x = self.embed_tokens(params, batch["tokens"])
            for i in range(cfg.n_layers):
                x, a = self._block(self._moe_block,
                                   _layer(params["blocks"], i), x)
                aux = aux + a
        elif cfg.family == "encdec":
            enc = self._encode(params, batch["frames"])
            x = self.embed_tokens(params, batch["tokens"])
            for i in range(cfg.n_layers):
                x = self._block(self._decdec_block,
                                _layer(params["blocks"], i), x, enc)
        else:
            x = self._embed_inputs(params, batch)
            for i in range(cfg.n_layers):
                x = self._block(self._dense_block,
                                _layer(params["blocks"], i), x)
            if cfg.family == "vlm":
                x = x[:, cfg.n_image_tokens:]
        x = self._norm(x, params["final_norm"])
        return self.unembed(params, x), aux

    # -- loss -------------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token NLL over the labels ``>= 0`` (the f32
        log-softmax of the logits), plus the forward's aux."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        # a negative label indexes from the end, as jnp.take_along_axis
        # does, and is masked out below
        idx = torch.where(labels < 0, labels + logp.shape[-1], labels)
        nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
        mask = (labels >= 0).float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0) + aux

    def _xlstm_groups(self):
        g = self.cfg.n_layers // self.cfg.slstm_every
        return g, self.cfg.slstm_every - 1

    def _xlstm_forward(self, params, batch):
        cfg = self.cfg
        x = self.embed_tokens(params, batch["tokens"])
        g, per = self._xlstm_groups()
        for gi in range(g):
            for j in range(per):
                x = self._block(self._mlstm_block,
                                _layer(params["mlstm"], gi * per + j), x)
            x = self._block(self._slstm_block, _layer(params["slstm"], gi),
                            x)
        return x

    def _mlstm_block(self, p, x):
        return x + XL.mlstm_parallel(p, self.cfg, self._norm(x, p["ln"]))[0]

    def _slstm_block(self, p, x):
        return x + XL.slstm_scan(p, self.cfg, self._norm(x, p["ln"]))[0]

    def _zamba_groups(self):
        """(groups of ``attn_every`` Mamba2 layers, each followed by the
        shared attention block; Mamba2 layers in the tail after them)."""
        cfg = self.cfg
        if cfg.attn_every <= 0:
            raise ValueError(f"{cfg.name}: hybrid needs attn_every > 0")
        g = cfg.n_layers // cfg.attn_every
        return g, cfg.n_layers - g * cfg.attn_every

    def _zamba_forward(self, params, batch):
        cfg = self.cfg
        x = self.embed_tokens(params, batch["tokens"])
        g, tail = self._zamba_groups()
        for gi in range(g):
            for j in range(cfg.attn_every):
                x = self._block(
                    self._mamba_residual,
                    _layer(params["mamba"], gi * cfg.attn_every + j), x)
            x = self._block(self._dense_block, params["shared_attn"], x)
        for i in range(tail):
            x = self._block(self._mamba_residual,
                            _layer(params["mamba_tail"], i), x)
        return x

    def _mamba_residual(self, p, x):
        return self._mamba_block(p, x)[0]

    # ======================================================================
    # decoding
    # ======================================================================
    def init_cache(self, batch_size: int, max_seq: int) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.family in ("dense", "vlm", "moe"):
            return L.init_kv_cache(cfg, cfg.n_layers, batch_size, max_seq,
                                   dt, dev)
        if cfg.family == "encdec":
            cache = L.init_kv_cache(cfg, cfg.n_layers, batch_size, max_seq,
                                    dt, dev)
            cache["xk"] = torch.zeros((cfg.n_layers, batch_size,
                                       cfg.n_frames, cfg.n_kv_heads, cfg.hd),
                                      dtype=dt, device=dev)
            cache["xv"] = torch.zeros_like(cache["xk"])
            return cache
        if cfg.family == "hybrid":
            g, tail = self._zamba_groups()
            ssm = (batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                   cfg.ssm_state)
            cache = L.init_kv_cache(cfg, g, batch_size, max_seq, dt, dev)
            cache["state"] = torch.zeros((g, cfg.attn_every, *ssm),
                                         dtype=dt, device=dev)
            if tail:
                cache["tail_state"] = torch.zeros((tail, *ssm), dtype=dt,
                                                  device=dev)
            return cache
        g, per = self._xlstm_groups()
        h, pd = cfg.n_heads, cfg.d_inner // cfg.n_heads
        spd = cfg.d_model // cfg.n_heads

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return {"m_c": zeros((g, per, batch_size, h, pd, pd)),
                "m_n": zeros((g, per, batch_size, h, pd)),
                "s_h": zeros((g, batch_size, h, spd)),
                "s_c": zeros((g, batch_size, h, spd), torch.float32),
                "s_n": zeros((g, batch_size, h, spd), torch.float32)}

    def decode_step(self, params, cache: dict, token: torch.Tensor, pos):
        """One serve step: next-token logits for ``token`` (B, 1) at
        absolute position ``pos``, the same across the batch: an int or a
        0-d integer tensor on the model's device, as the JAX package's
        step takes an int32 scalar.  Nothing in the step reads ``pos``
        back to the host, so a CUDA graph of the step (:class:`
        DecodeProgram`) replays at any position; an int gives the same
        step bit for bit (it becomes such a tensor).

        The cache is updated **in place** — the new K/V are written at
        slot ``pos`` clamped to ``W-1`` (``pos % W`` for a sliding-window
        ring buffer), an xLSTM's states overwritten — and returned: a caller
        must not reuse a cache expecting its old contents.
        """
        cfg = self.cfg
        if cfg.family != "ssm":             # xLSTM reads no position
            pos = L.position(pos, token.device)
        x = self.embed_tokens(params, token)
        if cfg.family == "ssm":
            x = self._xlstm_decode(params, cache, x)
        elif cfg.family == "hybrid":
            x = self._zamba_decode(params, cache, x, pos)
        elif cfg.family == "encdec":
            for i in range(cfg.n_layers):
                x = self._decode_decdec_block(_layer(params["blocks"], i), x,
                                              cache, i, pos)
        else:
            for i in range(cfg.n_layers):
                x = self._decode_attn_block(_layer(params["blocks"], i), x,
                                            cache["k"][i], cache["v"][i],
                                            pos)
        x = self._norm(x, params["final_norm"])
        return self.unembed(params, x), cache

    def _decode_attn_block(self, p, x, ck, cv, pos):
        """Pre-norm attention block against one layer's cache view."""
        x = self._decode_self_attn(p, x, ck, cv, pos)
        return x + self._ffn(p, self._norm(x, p["ln2"]))

    def _decode_decdec_block(self, p, x, cache, i: int, pos):
        """A whisper decoder block at one position: self-attention against
        cache layer ``i``, cross-attention (plain) to the encoder's K/V
        that ``prefill`` stored there, the MLP."""
        x = self._decode_self_attn(p, x, cache["k"][i], cache["v"][i], pos)
        q = L.project(self._norm(x, p["ln2"]), p["x_wq"])
        xk, xv = cache["xk"][i], cache["xv"][i]
        out = L.decode_attend(q, xk, xv, pos=xk.shape[1] - 1, window=0)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["x_wo"])
        return x + L.mlp(p, self.cfg, self._norm(x, p["ln3"]))

    def _decode_self_attn(self, p, x, ck, cv, pos):
        """Self-attention sublayer against one layer's cache view (written
        in place) at the 0-d position tensor ``pos``."""
        cfg = self.cfg
        h = self._norm(x, p["ln1"])
        b = x.shape[0]
        q, k, v = L.qkv_proj(p, cfg, h, pos.expand(b, 1))
        w = cfg.sliding_window
        if cfg.opt_decode and current_mesh() is not None:
            out = L.decode_update_attend_sharded(cfg, q, k, v, ck, cv, pos,
                                                 w)
            return x + torch.einsum("bshk,hkd->bsd", out, p["wo"])
        slot = L.cache_slot(pos, ck.shape[1], w)
        L.write_slot(ck, slot, k)
        L.write_slot(cv, slot, v)
        if cfg.attn_impl == "kernel" and not w:
            # flash-decode kernel: contiguous caches only (the ring-buffer
            # validity mask of SWA caches stays on the plain path); the
            # kernel reads the cache through a transposed view
            lengths = (pos + 1).to(torch.int32).expand(b).contiguous()
            out = ops.decode_attention(q[:, 0], ck.transpose(1, 2),
                                       cv.transpose(1, 2), lengths)[:, None]
        else:
            out = L.decode_attend(q, ck, cv, pos=pos, window=w)
        return x + torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _xlstm_decode(self, params, cache, x):
        cfg = self.cfg
        g, per = self._xlstm_groups()
        for gi in range(g):
            for j in range(per):
                p = _layer(params["mlstm"], gi * per + j)
                y, (c2, n2) = XL.mlstm_decode_step(
                    p, cfg, self._norm(x, p["ln"]),
                    (cache["m_c"][gi, j], cache["m_n"][gi, j]))
                x = x + y
                cache["m_c"][gi, j] = c2
                cache["m_n"][gi, j] = n2
            sp = _layer(params["slstm"], gi)
            y, states = XL.slstm_decode_step(
                sp, cfg, self._norm(x, sp["ln"]),
                (cache["s_h"][gi], cache["s_c"][gi], cache["s_n"][gi]))
            x = x + y
            for name, st in zip(("s_h", "s_c", "s_n"), states):
                cache[name][gi] = st
        return x

    def _zamba_decode(self, params, cache, x, pos):
        cfg = self.cfg
        g, tail = self._zamba_groups()

        def mamba_step(p, x, state):
            y, new = SSM.ssd_decode_step(p, cfg, self._norm(x, p["ln"]),
                                         state)
            state.copy_(new)
            return x + y

        for gi in range(g):
            for j in range(cfg.attn_every):
                x = mamba_step(_layer(params["mamba"],
                                      gi * cfg.attn_every + j), x,
                               cache["state"][gi, j])
            x = self._decode_attn_block(params["shared_attn"], x,
                                        cache["k"][gi], cache["v"][gi], pos)
        for i in range(tail):
            x = mamba_step(_layer(params["mamba_tail"], i), x,
                           cache["tail_state"][i])
        return x

    # -- prefill -----------------------------------------------------------
    def prefill(self, params, batch, max_seq: int, cache=None):
        """Run the full prompt, build the decode cache (into ``cache`` when
        given, an :meth:`init_cache` layout; a fresh one otherwise), return
        the last position's logits.

        Attention here is always the plain version (``attend_auto``
        without ``impl``), whatever ``cfg.attn_impl`` says: the JAX
        package's prefill does the same.  Norms and the hybrid's scans
        follow ``cfg.attn_impl``; the scan kernel's final state seeds the
        decode cache.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        b = tokens.shape[0]
        if cache is None:
            cache = self.init_cache(b, max_seq)
        if cfg.family == "ssm":
            return self._xlstm_prefill(params, tokens, cache)
        if cfg.family == "hybrid":
            return self._zamba_prefill(params, tokens, cache)
        enc = self._encode(params, batch["frames"]) \
            if cfg.family == "encdec" else None
        x = self._embed_inputs(params, batch)
        s_total = x.shape[1]
        positions = torch.arange(s_total, device=x.device).expand(
            b, s_total)
        slots = self._cache_slots(s_total, cache["k"].shape[2], x.device)
        for i in range(cfg.n_layers):
            x = self._prefill_attn_block(_layer(params["blocks"], i), x,
                                         positions, cache, i, slots, enc)
        if cfg.family == "vlm":
            x = x[:, cfg.n_image_tokens:]
        x = self._norm(x, params["final_norm"])
        return self.unembed(params, x[:, -1:]), cache

    def _cache_slots(self, s: int, w: int, device):
        """Cache slots of a prompt's last ``min(w, s)`` positions: the
        first slots of a contiguous cache (a slice), or ``p % w`` for
        position p of a sliding window's ring (an index tensor)."""
        take = min(w, s)
        if self.cfg.sliding_window:
            return torch.arange(s - take, s, device=device) % w
        return slice(0, take)

    def _prefill_attn_block(self, p, x, positions, cache, i: int, slots,
                            enc=None):
        """Pre-norm attention block over the prompt (plain attention),
        writing its last K/V rows into cache layer ``i`` at ``slots``; a
        whisper decoder block (``enc`` given) cross-attends to ``enc``
        and stores that layer's cross K/V in the cache too."""
        cfg = self.cfg
        q, k, v = L.qkv_proj(p, cfg, self._norm(x, p["ln1"]), positions)
        out = L.attend_auto(q, k, v, causal=True, window=cfg.sliding_window)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"])
        if enc is None:
            x = x + self._ffn(p, self._norm(x, p["ln2"]))
        else:
            xk, xv = self._cross_kv(p, enc)
            x = x + self._cross_attend(p, self._norm(x, p["ln2"]), xk, xv)
            x = x + L.mlp(p, cfg, self._norm(x, p["ln3"]))
            cache["xk"][i], cache["xv"][i] = xk, xv
        s = x.shape[1]
        take = slots.stop if isinstance(slots, slice) else len(slots)
        _write_rows(cache["k"][i], slots, k[:, s - take:], s)
        _write_rows(cache["v"][i], slots, v[:, s - take:], s)
        return x

    def _xlstm_prefill(self, params, tokens, cache):
        cfg = self.cfg
        x = self.embed_tokens(params, tokens)
        g, per = self._xlstm_groups()
        for gi in range(g):
            for j in range(per):
                p = _layer(params["mlstm"], gi * per + j)
                y, (c, n) = XL.mlstm_parallel(p, cfg,
                                              self._norm(x, p["ln"]))
                x = x + y
                cache["m_c"][gi, j] = c
                cache["m_n"][gi, j] = n
            sp = _layer(params["slstm"], gi)
            y, states = XL.slstm_scan(sp, cfg, self._norm(x, sp["ln"]))
            x = x + y
            for name, st in zip(("s_h", "s_c", "s_n"), states):
                cache[name][gi] = st
        x = self._norm(x, params["final_norm"])
        return self.unembed(params, x[:, -1:]), cache

    def _zamba_prefill(self, params, tokens, cache):
        cfg = self.cfg
        x = self.embed_tokens(params, tokens)
        b, s = tokens.shape
        g, tail = self._zamba_groups()
        positions = torch.arange(s, device=x.device).expand(b, s)
        slots = self._cache_slots(s, cache["k"].shape[2], x.device)
        for gi in range(g):
            for j in range(cfg.attn_every):
                x, cache["state"][gi, j] = self._mamba_block(
                    _layer(params["mamba"], gi * cfg.attn_every + j), x)
            x = self._prefill_attn_block(params["shared_attn"], x,
                                         positions, cache, gi, slots)
        for i in range(tail):
            x, cache["tail_state"][i] = self._mamba_block(
                _layer(params["mamba_tail"], i), x)
        x = self._norm(x, params["final_norm"])
        return self.unembed(params, x[:, -1:]), cache


class DecodeProgram:
    """The decode step as one program: the counterpart of
    ``jax.jit(model.decode_step)``, which the JAX package's tests and dry
    run compile once and run at every position.

    Built from ``(model, params, cache)``, the cache an :meth:`Model.
    init_cache` layout that the program owns: ``model.prefill(...,
    cache=program.cache)`` fills it eagerly, and every step writes it in
    place.  It holds static device buffers for the token (B, 1), B the
    cache's batch, and the position (0-d int32).  ``program(token,
    pos)`` copies both into their buffers (a device copy and a fill; no
    host sync), runs one step and returns its logits (B, 1, vocab).

    On the card the first call is the warm step, a real step checked for
    host syncs, and the capture (:func:`repro_torch.warm_and_capture`);
    every later call replays the graph, at whatever position its buffer
    holds, and clones the logits out of the graph's output.  A capture
    that fails raises: there is no eager path on the card.  A mesh's
    decode (``opt_decode``'s collectives) is not captured: a program
    built under active sharding rules raises.  On the CPU every call
    runs the body eagerly.

    The kernel wrappers' launch counters see the warm step and the
    capture (``eager_steps`` and ``captures``), never a replay.
    ``capture_s`` and ``instantiate_s`` are what the capture cost,
    ``nodes`` the graph's node count, ``replays`` the replayed steps."""

    eager_steps = 1             # the sync-checked warm step
    captures = 1

    def __init__(self, model: Model, params: dict, cache: dict):
        if current_mesh() is not None:
            raise RuntimeError(
                "DecodeProgram: a step under a mesh is not captured (its "
                "collectives were never run inside a CUDA graph); call "
                "Model.decode_step eagerly")
        self.model, self.params, self.cache = model, params, cache
        lead = cache["s_h" if model.cfg.family == "ssm" else "k"]
        dev = lead.device
        self.token = torch.zeros((lead.shape[1], 1), dtype=torch.long,
                                 device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph = None
        self._logits = None
        self.replays = 0
        self.nodes = 0
        self.capture_s = self.instantiate_s = 0.0

    def body(self) -> torch.Tensor:
        """One step at the buffers' token and position; returns the
        logits."""
        return self.model.decode_step(self.params, self.cache, self.token,
                                      self.pos)[0]

    def __call__(self, token: torch.Tensor, pos) -> torch.Tensor:
        if tuple(token.shape) != tuple(self.token.shape):
            raise ValueError(f"DecodeProgram: token of shape "
                             f"{tuple(token.shape)}, the program's is "
                             f"{tuple(self.token.shape)}")
        self.token.copy_(token)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(L.position(pos, self.pos.device))
        else:
            self.pos.fill_(pos)
        dev = self.token.device
        if dev.type != "cuda":
            return self.body()
        if self.graph is None:
            cap = warm_and_capture(self.body, dev)
            self.graph, self._logits = cap.graph, cap.out
            self.capture_s, self.instantiate_s = (cap.capture_s,
                                                  cap.instantiate_s)
            self.nodes = cap.nodes
            return cap.warm
        self.graph.replay()
        self.replays += 1
        return self._logits.clone()


class PrefillProgram:
    """The prefill as programs, one a prompt shape: the counterpart of
    ``jax.jit(lambda p, b: model.prefill(p, b, max_seq))``, which the JAX
    package's tests and dry run compile, a trace for each input shape.

    Built from ``(model, params, cache)``, the cache an :meth:`Model.
    init_cache` layout that another program owns, normally a
    :class:`DecodeProgram`'s (``PrefillProgram(model, params,
    decode.cache)``), so that a served request is a prefill replay and
    then step replays.  ``program(batch)`` runs the prompt
    (``batch["tokens"]`` (B, S), B the cache's batch, with ``"patches"``
    for the vlm family and ``"frames"`` for encdec), fills the cache in
    place and returns the last position's logits (B, 1, vocab).  The body
    first zeroes every cache leaf in place and then runs :meth:`Model.
    prefill` into it: the reference builds its cache fresh, and ``prefill
    (..., cache=)`` writes only the prompt's rows and states, so a cache
    that decode steps have written becomes the fresh prefill's, leaf for
    leaf.  No leaf is rebound: a decode graph holds their addresses.

    The shape key is each input's shape and dtype (what a jit traces anew
    on).  A key's first call copies the batch into static buffers of its
    own; on the card it then runs :func:`repro_torch.warm_and_capture` (a
    warm prefill under ``set_sync_debug_mode("error")``, whose logits it
    returns, then one capture), and every later call of the key copies
    the batch into those buffers, replays the graph and clones the logits
    out.  Keys live as long as the program, as a jit's traces do, each
    graph with a private memory pool that holds its prompt's
    activations.  A capture that fails raises: there is no eager path on
    the card.  A program built under active sharding rules raises, as
    :class:`DecodeProgram` does.  On the CPU every call runs the body
    eagerly and records its key alike.

    The kernel wrappers' launch counters see each key's warm prefill and
    capture (``eager_prefills`` and ``captures`` a key), never a replay.
    ``graphs`` maps a key to its :class:`repro_torch.Capture` (the graph,
    its logits buffer, nodes, capture and instantiate seconds) and
    ``inputs`` to its buffers; ``replays`` counts the replayed
    prefills."""

    eager_prefills = 1          # a key's sync-checked warm prefill
    captures = 1

    def __init__(self, model: Model, params: dict, cache: dict):
        if current_mesh() is not None:
            raise RuntimeError(
                "PrefillProgram: a prefill under a mesh is not captured (its "
                "collectives were never run inside a CUDA graph); call "
                "Model.prefill eagerly")
        self.model, self.params, self.cache = model, params, cache
        family = model.cfg.family
        self.batch_size = cache["s_h" if family == "ssm" else "k"].shape[1]
        # prefill reads max_seq only to build a cache, and is given one
        self.max_seq = cache["k"].shape[2] if "k" in cache else 0
        self.names = ("tokens",) + {"vlm": ("patches",),
                                    "encdec": ("frames",)}.get(family, ())
        self.shape_keys: set = set()
        self.inputs: dict = {}
        self.graphs: dict = {}
        self.replays = 0

    def key(self, batch: dict) -> tuple:
        """The prompt's shape key: each input's name, shape and dtype."""
        return tuple((n, tuple(batch[n].shape), batch[n].dtype)
                     for n in self.names)

    def body(self, inputs: dict) -> torch.Tensor:
        """The cache zeroed, then the prompt ``inputs`` prefilled into it;
        returns the logits."""
        for leaf in self.cache.values():
            leaf.zero_()
        return self.model.prefill(self.params, inputs, self.max_seq,
                                  cache=self.cache)[0]

    def __call__(self, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        if tokens.dim() != 2 or tokens.shape[0] != self.batch_size:
            raise ValueError(f"PrefillProgram: tokens of shape "
                             f"{tuple(tokens.shape)}, want (B, S) with B "
                             f"the cache's {self.batch_size}")
        key = self.key(batch)
        self.shape_keys.add(key)
        dev = tokens.device
        if dev.type != "cuda":
            return self.body({n: batch[n] for n in self.names})
        cap = self.graphs.get(key)
        if cap is None:
            inputs = {n: batch[n].clone() for n in self.names}
            cap = warm_and_capture(lambda: self.body(inputs), dev)
            self.inputs[key] = inputs
            self.graphs[key] = cap._replace(warm=None)
            return cap.warm
        for n, buf in self.inputs[key].items():
            buf.copy_(batch[n])
        cap.graph.replay()
        self.replays += 1
        return cap.out.clone()
