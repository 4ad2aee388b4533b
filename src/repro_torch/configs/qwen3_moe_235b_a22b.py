"""Qwen3-MoE 235B-A22B (hf:Qwen/Qwen3-30B-A3B scaled to 94 layers): every
layer's FFN is a mixture of 128 experts of width 1536, top-8 routed; GQA
64/4 in the grouped layout with qk-norm, untied embeddings and a 4096-token
sliding window for long contexts.  Its training state (16 B a parameter)
fits no one host's cards: ``launch/train.py`` names the smallest grid it
fits on."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B (assignment: 94L scaled sibling)",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert FFN width
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    sliding_window=4096,
)
