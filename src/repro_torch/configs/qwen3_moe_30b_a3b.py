"""Qwen3-MoE 30B-A3B (hf:Qwen/Qwen3-30B-A3B): every layer's FFN is a
mixture of 128 experts of width 768, top-8 routed; GQA 32/4 with qk-norm,
untied embeddings and a 4096-token sliding window for long contexts."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    attn_flat=True,  # wq [d, H, 1, Dh]: kv broadcast per group of 8 q heads
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert FFN width
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    sliding_window=4096,
)
