"""Evaluation: development-set perplexity (the paper's Fig. 4 metric)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import seq2seq as s2s
from repro_torch.models.common import tree_leaves
from repro_torch.train.trainer import batch_to_device


def perplexity(params, cfg: ModelConfig, batches, *, max_batches: int = 8, stage_kernel: str = "cuda") -> float:
    """Token-level perplexity of the seq2seq model over an iterator of numpy
    batches, on the params' device, without dropout."""
    device = tree_leaves(params)[0].device
    total_nll, total_tok = 0.0, 0.0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            t = batch_to_device(batch, device)
            b = s2s.Seq2SeqBatch(t["src"], t["tgt_in"], t["tgt_out"], t["src_mask"], t["tgt_mask"])
            loss, extras = s2s.forward(params, cfg, b, stage_kernel=stage_kernel)
            n = float(extras["denom"])
            total_nll += float(loss) * n
            total_tok += n
    return math.exp(min(total_nll / max(total_tok, 1.0), 30.0))
