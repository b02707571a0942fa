"""Registry of the 10 assigned architectures (+ reduced smoke variants).

A copy of ``repro.configs.registry``.  Every entry cites its source;
exact dimensions follow the assignment table.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, reduced

GROK_1_314B = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, d_ff_expert=32768, act="gelu",
    source="hf:xai-org/grok-1")

QWEN3_MOE_30B = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
    n_experts=128, top_k=8, d_ff_expert=768, act="silu",
    source="hf:Qwen/Qwen3-30B-A3B")

WHISPER_MEDIUM = ArchConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51865,
    enc_layers=24, n_frames=1500, act="gelu", tie_embeddings=True,
    source="arXiv:2212.04356 (conv frontend stubbed)")

LLAVA_NEXT_34B = ArchConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    n_image_tokens=2880, act="silu",
    source="hf:llava-hf/llava-v1.6 (anyres ViT tower stubbed)")

STARCODER2_3B = ArchConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, head_dim=128, d_ff=12288, vocab=49152,
    act="gelu", qkv_bias=True, long_context_window=8192,
    source="arXiv:2402.19173 (GQA, RoPE; SWA variant for 500k serving)")

QWEN2_72B = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    act="silu", qkv_bias=True, long_context_window=8192,
    source="arXiv:2407.10671 (GQA, QKV bias; SWA variant for 500k)")

XLSTM_1_3B = ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, slstm_every=8,
    source="arXiv:2405.04517 (sLSTM + mLSTM blocks, 7:1)")

NEMOTRON_4_340B = ArchConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv_heads=8, head_dim=192, d_ff=73728, vocab=256000,
    act="sq_relu", long_context_window=8192,
    source="arXiv:2402.16819 (GQA, squared-ReLU; SWA variant for 500k)")

ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm_state=64, attn_every=6, long_context_window=4096,
    source="arXiv:2411.15242 (Mamba2 + shared attn block)")

GRANITE_3_2B = ArchConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192, vocab=49155,
    act="silu", long_context_window=8192, tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base (SWA variant for 500k)")

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    GROK_1_314B, QWEN3_MOE_30B, WHISPER_MEDIUM, LLAVA_NEXT_34B,
    STARCODER2_3B, QWEN2_72B, XLSTM_1_3B, NEMOTRON_4_340B, ZAMBA2_7B,
    GRANITE_3_2B]}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced(name: str, **kw) -> ArchConfig:
    return reduced(get(name), **kw)
