"""Qwen3-1.7B (hf:Qwen/Qwen3-8B family): a dense decoder with qk-norm and
GQA 16/8, tied embeddings and a 4096-token sliding window for long
contexts."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (assignment: 1.7B sibling)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    attn_flat=True,  # wq [d, H, 1, Dh]: kv broadcast per group of 2 q heads
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sliding_window=4096,
)
