"""Architecture registry of the port.

``get_config(arch_id)`` returns the full configuration;
``get_config(arch_id, smoke=True)`` the reduced smoke variant.  The
registry holds only the architectures the port serves so far.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, reduced  # noqa: F401

# arch id -> module name in this package
_REGISTRY = {
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "seq2seq-rnn": "seq2seq_rnn",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: {sorted(_REGISTRY)}")
    cfg = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}").CONFIG
    return reduced(cfg) if smoke else cfg
