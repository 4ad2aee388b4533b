"""Plain PyTorch versions of the flash attention forward, in the kernel
layout of ``repro/kernels/flash_attn/kernel.py``.

q [BH, S, D], k/v [BH / group, T, D] -> [BH, S, D] in q's dtype.  Query row
``bh`` reads kv row ``bh // group``; q and k positions both start at 0;
scores are scaled by ``D ** -0.5``; ``causal`` keeps keys with
kpos <= qpos and ``window`` those with kpos > qpos - window.

* :func:`flash_attention_plain` is the online softmax over kv blocks, fp32
  running (max, denom, acc), with the TPU kernel's block pruning; it mirrors
  ``repro/models/attention.py::chunked_attention``.  ``ops.flash_attention_fused``
  runs it on CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
  against it on the card.
* :func:`flash_attention_dense` is the O(S*T) oracle for the tests
  (``repro/kernels/flash_attn/ref.py``'s, in the same layout).

A query row that sees no key at all (only possible when S > T) gets zeros
from the plain version and the kernel alike; the dense oracle gives it the
mean of v.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # masked score: finite, like the TPU kernel's


def _mask(q0: int, q1: int, k0: int, k1: int, causal: bool, window, device) -> torch.Tensor:
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None, group: int = 1,
                          block_q: int = 256, block_kv: int = 256):
    """Online-softmax attention in fp32, block by block; any S and T."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    scale = D**-0.5
    qg = q.reshape(BKV, group, S, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((BKV, group, S, D), dtype=q.dtype, device=q.device)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qc = qg[:, :, q0:q1].float() * scale
        lo, hi = 0, T
        if causal:  # blocks above the diagonal hold no key any row of this block sees
            hi = min(T, q1)
        if window is not None:  # nor do blocks left of the window
            lo = max(0, q0 + 1 - window)
        lo = (lo // block_kv) * block_kv
        m = torch.full((BKV, group, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BKV, group, q1 - q0, D), device=q.device)
        for k0 in range(lo, hi, block_kv):
            k1 = min(k0 + block_kv, T)
            s = torch.einsum("bgsd,btd->bgst", qc, kf[:, k0:k1])
            s = torch.where(_mask(q0, q1, k0, k1, causal, window, q.device), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bgst,btd->bgsd", p, vf[:, k0:k1])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q1] = torch.where((m > NEG_INF)[..., None], o, 0.0).to(q.dtype)
    return out.reshape(BH, S, D)


def flash_attention_dense(q, k, v, *, causal: bool = True, window=None, group: int = 1):
    """The O(S*T) oracle: every score at once, fp32 softmax."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    qg = q.reshape(BKV, group, S, D).float()
    s = torch.einsum("bgsd,btd->bgst", qg, k.float()) * (1.0 / D**0.5)
    s = torch.where(_mask(0, S, 0, T, causal, window, q.device), s, NEG_INF)
    o = torch.einsum("bgst,btd->bgsd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype).reshape(BH, S, D)
