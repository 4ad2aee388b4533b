"""Plain PyTorch version of the fused Luong head (paper eq. 1-4).

fp32 inside like ``repro/kernels/luong_attn/ref.py``; the output is in
``H.dtype``.  The CPU path of ``ops.luong_attention_fused`` runs this, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # masked score: finite, so an all-masked row softmaxes to uniform


def luong_attention_ref(H, S, src_mask, w_alpha, w_ch, w_cc):
    """H [B,N,h], S [B,M,h], src_mask [B,M] (bool or int), w_* [h,h] -> Hc [B,N,h]."""
    Hf, Sf = H.float(), S.float()
    scores = torch.matmul(torch.matmul(Hf, w_alpha.float()), Sf.transpose(1, 2))  # [B,N,M]
    scores = torch.where(src_mask[:, None, :] != 0, scores, torch.full((), NEG_INF, device=scores.device))
    alpha = torch.softmax(scores, dim=-1)  # eq. 1-2
    C = torch.matmul(alpha, Sf)  # eq. 3
    hc = torch.tanh(torch.matmul(Hf, w_ch.float()) + torch.matmul(C, w_cc.float()))  # eq. 4
    return hc.to(H.dtype)
