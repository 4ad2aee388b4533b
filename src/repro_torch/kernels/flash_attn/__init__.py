from repro_torch.kernels.flash_attn.ops import flash_attention, flash_attention_fused  # noqa: F401
