"""Evaluation: development-set perplexity (the paper's Fig. 4 metric)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves
from repro_torch.train.trainer import batch_to_device


def perplexity(params, cfg: ModelConfig, batches, *, max_batches: int = 8, stage_kernel: str = "cuda") -> float:
    """Token-level perplexity over an iterator of numpy batches, on the
    params' device, without dropout: the seq2seq model's, or an LM's through
    ``forward_train`` without remat, its CE alone (the MoE load-balance term
    left out, as in the JAX package)."""
    device = tree_leaves(params)[0].device
    total_nll, total_tok = 0.0, 0.0
    ctx = tfm.RunCtx(mode="train", kernel=stage_kernel, remat=False)
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            t = batch_to_device(batch, device)
            if cfg.family == "seq2seq":
                b = s2s.Seq2SeqBatch(t["src"], t["tgt_in"], t["tgt_out"], t["src_mask"], t["tgt_mask"])
                loss, extras = s2s.forward(params, cfg, b, stage_kernel=stage_kernel)
            else:
                _, extras = tfm.forward_train(params, cfg, t["tokens"], t["labels"], t["mask"], ctx=ctx)
                loss = extras["ce"]
            n = float(extras["denom"])
            total_nll += float(loss) * n
            total_tok += n
    return math.exp(min(total_nll / max(total_tok, 1.0), 30.0))
