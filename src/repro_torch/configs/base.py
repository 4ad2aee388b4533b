"""Configuration dataclass for the ported architectures.

The port's own copy of the fields of ``repro.configs.base.ModelConfig``
that the ported families read, with the same defaults, and of
:func:`reduced`, the smoke-test variant.  Fields of families that are not
ported yet (MoE, Mamba, xLSTM, frontends) are left out until their slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FAMILIES = ("seq2seq",)  # the families the port serves so far


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

    def param_count(self) -> int:
        """Analytic parameter count of the seq2seq model: two embedding
        tables, the two stacked LSTMs, W_alpha, W_c and the output head F_c."""
        h, e, v = self.d_model, self.emb_size, self.vocab_size
        lstm = lambda in_dim: 4 * h * (in_dim + h + 1)
        n = 2 * v * e + (0 if self.tie_embeddings else v * h)
        dec_in0 = e + (h if self.input_feeding else 0)
        for li in range(self.num_layers):
            n += lstm(e if li == 0 else h) + lstm(dec_in0 if li == 0 else h)
        return n + 3 * h * h


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (the same numbers as
    ``repro.configs.base.reduced`` gives for the ported families)."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        emb_size=min(cfg.emb_size, d_model),
        max_seq_len=4096,
    )
