from repro_torch.kernels.luong_attn.ops import luong_attention_fused  # noqa: F401
