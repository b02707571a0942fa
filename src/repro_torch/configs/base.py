"""Architecture configuration schema and reduced-variant helper.

A copy of ``repro.configs.base`` (the port never imports the JAX
package).  One difference: ``attn_impl`` takes ``"ref"`` (plain PyTorch)
or ``"kernel"`` (every op of the model's path that has a hand-written
kernel: flash attention, flash decode, RMSNorm, the Mamba2 selective
scan and the MoE expert GEMMs), where the JAX package says ``"pallas"``;
:func:`repro_torch.convert.arch_from_fields` maps one to the other.
``remat`` is honoured in training: each block whose parameters require
grad is recomputed in the backward pass (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``; no number changes), saving nothing
under ``remat_policy="full"`` and the outputs of the matmuls with no
batch dimension under ``"dots"``.  ``opt_decode`` takes the sharded
flash-decode when a mesh is active (``launch.sharding.sharding_rules``).
``expert_split`` s > 1 takes the split-expert parameter layout; -1
("auto") is resolved against a mesh by ``launch.dryrun.build``.
``unroll_layers`` steers JAX-only machinery (the port always loops over
layers) and is kept so that a config converts field for field.
``moe_groups`` is honoured: MoE dispatch and its capacity are per group,
so it changes results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One selectable architecture (``--arch <name>``)."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    act: str = "silu"           # silu | gelu | sq_relu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # -- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 1         # dispatch groups (launcher: data shards)
    # -- SSM (Mamba2) / hybrid -------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0         # hybrid: shared attn block every k ssm layers
    # -- xLSTM -----------------------------------------------------------
    slstm_every: int = 0        # 1 sLSTM per this many layers (rest mLSTM)
    # -- encoder-decoder (audio) ------------------------------------------
    enc_layers: int = 0
    n_frames: int = 0           # stub frontend sequence length
    # -- VLM ---------------------------------------------------------------
    n_image_tokens: int = 0     # stub vision tower output length
    # -- attention variants -------------------------------------------------
    sliding_window: int = 0     # 0 = full causal; >0 = banded (sub-quadratic)
    long_context_window: int = 0  # SWA width used ONLY for the long_500k
                                  # serving variant (cfg is otherwise full)
    # -- optimizations (§Perf) -------------------------------------------
    attn_impl: str = "ref"      # "ref" (plain PyTorch) | "kernel" (every
                                # op with a hand-written kernel: flash
                                # attention, flash decode, RMSNorm, the
                                # selective scan, the MoE expert GEMMs;
                                # plain versions on CPU tensors)
    opt_decode: bool = False    # shard_map flash-decode (beyond-paper)
    expert_split: int = 1       # split each expert's d_ff s-ways so the
                                # (E·s) dim divides the model axis: true
                                # expert-tensor parallelism for grok's 8
                                # experts on a 16-way axis (beyond-paper)
    remat_policy: str = "full"  # "full" (nothing saveable) or "dots"
                                # (save matmul outputs; less recompute,
                                # more resident activations — §Perf)
    # -- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    unroll_layers: bool = False  # Python-loop layers instead of lax.scan
                                 # (roofline delta method: cost_analysis
                                 # counts a while body only once)
    source: str = ""            # paper / model-card citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:   # Mamba2 / mLSTM expansion
        return 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_decode(self) -> bool:
        return True             # all assigned archs have a decoder

    def supports_long_context(self) -> bool:
        """Sub-quadratic serving at 500k context (see DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0 \
            or self.long_context_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * (h + 2 * kv) * hd + h * hd * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        elif self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "ssm":
            blocks = self.n_layers * self._xlstm_block_params() \
                if self.slstm_every else self.n_layers * self._mamba_params()
        elif self.family == "hybrid":
            blocks = self.n_layers * self._mamba_params() + (attn + mlp)
        elif self.family == "encdec":
            blocks = self.enc_layers * (attn + mlp) + \
                self.n_layers * (2 * attn + mlp)
        else:
            blocks = self.n_layers * (attn + mlp)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return int(blocks + embed)

    def _mamba_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        return d * (2 * di + 2 * n + self.ssm_heads) + di * d

    def _xlstm_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        return 3 * d * di + di * d + 2 * d * 4

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.d_ff_expert)
        return int(dense + self.n_layers * self.top_k * 3 * d *
                   self.d_ff_expert)


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 128,
            vocab: int = 512) -> ArchConfig:
    """CPU-smoke-test variant of the same family (≤512 wide, 2 layers)."""
    scale = d_model / cfg.d_model
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    repl = dict(
        n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=max(32, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab=vocab, dtype="float32", param_dtype="float32", remat=False,
    )
    if cfg.family == "moe":
        # capacity 8.0 → effectively dropless, so prefill/decode dispatch
        # is batch-shape independent and exactly matches the forward pass
        repl.update(n_experts=4, top_k=min(2, cfg.top_k),
                    d_ff_expert=max(32, int(cfg.d_ff_expert * scale)),
                    capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        repl.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_every:
        repl.update(attn_every=1, n_layers=2)
    if cfg.slstm_every:
        repl.update(slstm_every=2, n_layers=2)
    if cfg.enc_layers:
        repl.update(enc_layers=n_layers, n_frames=16)
    if cfg.n_image_tokens:
        repl.update(n_image_tokens=8)
    if cfg.sliding_window or cfg.long_context_window:
        repl.update(sliding_window=16, long_context_window=16)
    return dataclasses.replace(cfg, **repl)
