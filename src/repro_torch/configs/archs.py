"""The 10 assigned architectures — exact values from the assignment table
(the port of ``repro.configs.archs``: the same values, inline).

Reduced smoke variants (same family, tiny dims) are derived by ``smoke_of``.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, register


@register
def moonshot_v1_16b_a3b() -> ArchConfig:
    # kimi/moonlight: 64 routed experts top-6 [hf:moonshotai/Moonlight-16B-A3B]
    return ArchConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=11264, vocab_size=163840,
        attn_kind="gqa", ffn_kind="swiglu", n_experts=64, n_experts_per_tok=6,
        n_shared_experts=2, moe_d_ff=1408, first_k_dense=1, rope_theta=5e4,
        grad_accum=4,
        notes="dense d_ff = 8*moe_d_ff for the first dense layer",
    )


@register
def deepseek_v3_671b() -> ArchConfig:
    # MLA + 1 shared + 256 routed top-8 [arXiv:2412.19437]
    return ArchConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
        attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, ffn_kind="swiglu", n_experts=256,
        n_experts_per_tok=8, n_shared_experts=1, moe_d_ff=2048,
        first_k_dense=3, rope_theta=1e4, grad_accum=8,
        opt_state_dtype="bfloat16",
        notes="MTP head omitted (training objective addon; see DESIGN.md)",
    )


@register
def qwen3_0_6b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=3072, vocab_size=151936, head_dim=128,
        attn_kind="gqa", qk_norm=True, ffn_kind="swiglu", rope_theta=1e6,
        tie_embeddings=True,
    )


@register
def gemma_2b() -> ArchConfig:
    # GeGLU, head_dim=256, MQA [arXiv:2403.08295]
    return ArchConfig(
        name="gemma-2b", family="dense", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, d_ff=16384, vocab_size=256000, head_dim=256,
        attn_kind="gqa", ffn_kind="geglu", rope_theta=1e4, scale_embed=True,
        tie_embeddings=True,
    )


@register
def qwen3_14b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=17408, vocab_size=151936,
        head_dim=128, attn_kind="gqa", qk_norm=True, ffn_kind="swiglu",
        rope_theta=1e6, grad_accum=4,
    )


@register
def minicpm3_4b() -> ArchConfig:
    # MLA [hf:openbmb/MiniCPM3-4B]
    return ArchConfig(
        name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=6400, vocab_size=73448,
        attn_kind="mla", q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
        qk_rope_dim=32, v_head_dim=64, ffn_kind="swiglu", rope_theta=1e4,
        grad_accum=4,
    )


@register
def whisper_small() -> ArchConfig:
    # enc-dec; conv frontend stubbed: input_specs feeds frame embeddings
    return ArchConfig(
        name="whisper-small", family="audio", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
        attn_kind="gqa", ffn_kind="mlp", rope_theta=0.0, enc_dec=True,
        n_enc_layers=12, enc_len=1500,
        notes="sinusoidal positions (learned dec pos emb simplified away); "
              "MLP biases omitted",
    )


@register
def qwen2_vl_72b() -> ArchConfig:
    # M-RoPE, dynamic resolution (patch embeddings stubbed) [arXiv:2409.12191]
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064,
        attn_kind="gqa", ffn_kind="swiglu", rope_theta=1e6, m_rope=True,
        n_patches=256, grad_accum=8, opt_state_dtype="bfloat16",
    )


@register
def rwkv6_1_6b() -> ArchConfig:
    # Finch — data-dependent decay [arXiv:2404.05892]
    return ArchConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=7168, vocab_size=65536,
        attn_kind="none", ssm_kind="rwkv6", ffn_kind="rwkv",
        sub_quadratic=True,
    )


@register
def jamba_v0_1_52b() -> ArchConfig:
    # Mamba+attn 1:7 interleave, MoE 16e top-2 every other layer
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
        attn_kind="gqa", ffn_kind="swiglu", n_experts=16, n_experts_per_tok=2,
        moe_d_ff=14336, attn_every=8, moe_every=2, ssm_kind="mamba",
        d_state=16, d_conv=4, expand=2, rope_theta=1e4, sub_quadratic=True,
        grad_accum=8, opt_state_dtype="bfloat16",
    )


def smoke_of(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    over = dict(
        n_layers=min(cfg.n_layers, 4), d_model=128, d_ff=256,
        vocab_size=512, params_dtype="float32", compute_dtype="float32",
        enc_len=32, n_patches=8 if cfg.n_patches else 0,
        grad_accum=1, opt_state_dtype="float32",
    )
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=min(max(cfg.n_kv_heads, 1), 2),
                    head_dim=32)
    if cfg.attn_kind == "mla":
        over.update(q_lora_rank=(64 if cfg.q_lora_rank else 0),
                    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                    v_head_dim=16)
    if cfg.is_moe:
        over.update(n_experts=8, n_experts_per_tok=2, moe_d_ff=64,
                    first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.family == "hybrid":
        over.update(n_layers=8, attn_every=4, moe_every=2)
    if cfg.enc_dec:
        over.update(n_enc_layers=2, n_layers=2)
    return dataclasses.replace(cfg, **over, name=cfg.name + "-smoke")
