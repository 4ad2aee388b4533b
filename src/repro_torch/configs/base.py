"""Configuration dataclass for the ported architectures.

The port's own copy of the fields of ``repro.configs.base.ModelConfig``
that the ported families (dense and MoE decoders, and the paper's seq2seq)
read, with the same defaults, of :class:`MoEConfig`, and of :func:`reduced`,
the smoke-test variant.  Fields of families that are not ported yet (Mamba,
xLSTM, encoder stacks, frontends) are left out until their slice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

FAMILIES = ("dense", "moe", "seq2seq")  # the families the port serves so far


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (Switch/Qwen3-MoE style)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # A layer uses MoE iff (layer_index % every) == offset.
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    source: str  # citation for the configuration

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    # projection layout: "grouped" keeps wq as [d, KV, G, Dh]; "flat" keeps
    # [d, H, 1, Dh] and kv is broadcast per group at use
    attn_flat: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim that is rotated
    sliding_window: Optional[int] = None
    learned_pos_emb: bool = False

    # norms / activations
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "silu"  # "silu" | "gelu" | "tanh" | "relu"
    gated_mlp: bool = True

    # block pattern: layer i is attention iff (i % attn_every) == attn_offset
    attn_every: int = 1
    attn_offset: int = 0

    moe: Optional[MoEConfig] = None

    # seq2seq (paper model) specifics
    input_feeding: bool = False
    emb_size: int = 0  # 0 -> d_model (paper uses 512 emb vs 1024 hidden)

    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    dropout: float = 0.0
    dtype: str = "bfloat16"  # compute dtype; params fp32

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} is not ported yet; ported: {FAMILIES}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.emb_size == 0:
            object.__setattr__(self, "emb_size", self.d_model)
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attn_layer(self, i: int) -> bool:
        return (i % self.attn_every) == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every) == self.moe.offset

    @property
    def layer_group(self) -> int:
        """Period of the layer pattern; weights are stacked as
        [num_layers // layer_group, ...] per position in the group."""
        period = 1
        for every in (self.attn_every, self.moe.every if self.moe is not None else 1):
            if every > 1:
                period = period * every // math.gcd(period, every)
        return period

    def param_count(self) -> int:
        """Analytic parameter count, ``repro.configs.base._param_count``'s
        formula for the ported families.  For the dense and MoE families it
        leaves out the qk-norm scales (2 * head_dim per layer), as that
        formula does."""
        d, v = self.d_model, self.vocab_size
        n = v * self.emb_size + (0 if self.tie_embeddings else v * d)
        if self.family == "seq2seq":
            h, e = d, self.emb_size
            lstm = lambda in_dim: 4 * h * (in_dim + h + 1)
            n += v * e  # the target embedding
            dec_in0 = e + (h if self.input_feeding else 0)
            for li in range(self.num_layers):
                n += lstm(e if li == 0 else h) + lstm(dec_in0 if li == 0 else h)
            return n + 3 * h * h  # W_alpha, W_c
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            mult = 3 if self.gated_mlp else 2
            if self.is_moe_layer(i):  # router + experts
                m = self.moe
                n += d * m.num_experts + m.num_experts * mult * d * m.d_ff_expert
            elif self.d_ff:
                n += mult * d * self.d_ff
            n += 2 * d  # norms
        return n + d  # final norm


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family and block pattern, tiny dims (the
    same numbers as ``repro.configs.base.reduced`` gives for the ported
    families)."""
    period = cfg.layer_group
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=period if period > 1 else 2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        emb_size=min(cfg.emb_size, d_model),
        max_seq_len=4096,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=min(cfg.moe.d_ff_expert, 128)
        )
    if cfg.sliding_window:
        changes["sliding_window"] = 64
    return dataclasses.replace(cfg, **changes)
