"""GQA attention (port of ``repro/models/attention.py``): prefill attention,
cached decode, sliding window.

Shapes: q grouped [B, S, KV, G, D] (or flat [B, S, H, 1, D] with
``cfg.attn_flat``); k, v [B, T, KV, D].  :func:`attend` is the prefill entry
point: ``kernel="cuda"`` goes through ``kernels/flash_attn`` (the hand-written
kernel on CUDA tensors, its plain version on CPU tensors), ``kernel="torch"``
through :func:`chunked_attention`, the plain PyTorch mirror of the JAX
package's.  Decode attends with :func:`decode_attention` /
:func:`decode_attention_concat` against a cache that :func:`cache_update`
writes in place (the JAX package returns a new cache; in place saves a copy
of every layer's cache per token).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import common
from repro_torch.models.common import Initializer

NEG_INF = -1e30
KERNELS = ("torch", "cuda")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_attention(ini: Initializer, path: str, cfg: ModelConfig) -> dict:
    """Grouped layout: wq [d, KV, G, Dh], wo [KV, G, Dh, d]; flat layout:
    wq [d, H, 1, Dh], wo [H, 1, Dh, d] (kv broadcast per group at use)."""
    d, KV, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    if cfg.attn_flat:
        q_shape, o_shape, bq_shape = (d, cfg.num_heads, 1, Dh), (cfg.num_heads, 1, Dh, d), (cfg.num_heads, 1, Dh)
    else:
        q_shape, o_shape, bq_shape = (d, KV, G, Dh), (KV, G, Dh, d), (KV, G, Dh)
    p = {
        "wq": ini.normal(path + ".wq", q_shape, scale=d**-0.5),
        "wk": ini.normal(path + ".wk", (d, KV, Dh), scale=d**-0.5),
        "wv": ini.normal(path + ".wv", (d, KV, Dh), scale=d**-0.5),
        "wo": ini.normal(path + ".wo", o_shape, scale=(KV * G * Dh) ** -0.5),
    }
    if cfg.qkv_bias:
        p |= {
            "bq": ini.zeros(path + ".bq", bq_shape),
            "bk": ini.zeros(path + ".bk", (KV, Dh)),
            "bv": ini.zeros(path + ".bv", (KV, Dh)),
        }
    if cfg.qk_norm:
        p |= {"q_norm": ini.ones(path + ".qn", (Dh,)), "k_norm": ini.ones(path + ".kn", (Dh,))}
    return p


def attention_specs(cfg: ModelConfig) -> dict:
    """The logical spec tree of :func:`init_attention`'s parameters, as
    ``repro/models/attention.py::init_attention`` returns it beside them:
    the flat layout shards the q heads (``heads``), the grouped one
    ``kv_heads`` or else ``q_groups``; k and v are on ``kv_heads``."""
    if cfg.attn_flat:
        q, o, bq = ("embed", "heads", None, None), ("heads", None, None, "embed"), ("heads", None, None)
    else:
        q, o, bq = ("embed", "kv_heads", "q_groups", None), ("kv_heads", "q_groups", None, "embed"), \
            ("kv_heads", "q_groups", None)
    s = {"wq": q, "wk": ("embed", "kv_heads", None), "wv": ("embed", "kv_heads", None), "wo": o}
    if cfg.qkv_bias:
        s |= {"bq": bq, "bk": ("kv_heads", None), "bv": ("kv_heads", None)}
    if cfg.qk_norm:
        s |= {"q_norm": ("state",), "k_norm": ("state",)}
    return s


def kv_block(p: dict, cfg: ModelConfig, m: int) -> Optional[slice]:
    """On a tensor-parallel rank (coordinate ``m`` of ``model``) whose flat
    ``wq`` holds a block of the q heads while ``wk``/``wv`` are whole (the
    kv heads do not split over the axis, as the MoE model's 4 at 8 ranks):
    the kv heads that block reads, which :func:`project_qkv` then projects
    alone.  None when the rank's k and v heads are the ones its q heads read
    already (no tensor parallelism; kv heads sharded; the grouped layout)."""
    Hl = p["wq"].shape[1]
    if not cfg.attn_flat or Hl == cfg.num_heads or p["wk"].shape[1] != cfg.num_kv_heads:
        return None
    G = cfg.num_heads // cfg.num_kv_heads
    if G % Hl:
        raise NotImplementedError(f"{Hl} q heads a rank over {cfg.num_kv_heads} whole kv heads of {G} q heads each: "
                                  "a rank's q heads must read one kv head")
    lo = m * Hl // G
    return slice(lo, lo + 1)


def project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv: Optional[slice] = None):
    """x [B,S,d] -> q [B,S,KV,G,D] (or flat), k, v [B,S,KV,D] in x's dtype;
    ``kv``: only those kv heads (:func:`kv_block`)."""
    dt = x.dtype
    wk, wv = (p["wk"], p["wv"]) if kv is None else (p["wk"][:, kv], p["wv"][:, kv])
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"].to(dt))
    k = torch.einsum("btd,dkh->btkh", x, wk.to(dt))
    v = torch.einsum("btd,dkh->btkh", x, wv.to(dt))
    if "bq" in p:
        bk, bv = (p["bk"], p["bv"]) if kv is None else (p["bk"][kv], p["bv"][kv])
        q, k, v = q + p["bq"].to(dt), k + bk.to(dt), v + bv.to(dt)
    if "q_norm" in p:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    return q, k, v


# ---------------------------------------------------------------------------
# dense and chunked (plain) attention
# ---------------------------------------------------------------------------


def _match_kv(q, k, v):
    """Broadcast kv heads to q's layout: grouped q has k's KV; flat q has H
    there (G == 1), and head h reads kv head h // (H / KV)."""
    KVq, KVk = q.shape[2], k.shape[2]
    if KVq != KVk:
        rep = KVq // KVk

        def expand(x):
            B, T, KV, D = x.shape
            return x[:, :, :, None].expand(B, T, KV, rep, D).reshape(B, T, KV * rep, D)

        k, v = expand(k), expand(v)
    return k, v


def _keep(qpos, kpos, causal: bool, window):
    keep = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def dense_attention(q, k, v, *, causal: bool, window: Optional[int] = None, q_offset: int = 0):
    """O(S*T) attention, fp32 inside.  q grouped [B,S,KV,G,D]; returns q's
    layout and dtype.  ``q_offset``: absolute position of q[0]."""
    k, v = _match_kv(q, k, v)
    S, D = q.shape[1], q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * (1.0 / math.sqrt(D))
    qpos = q_offset + torch.arange(S, device=q.device)
    keep = _keep(qpos, torch.arange(k.shape[1], device=q.device), causal, window)
    scores = torch.where(keep, scores, NEG_INF)
    out = torch.einsum("bkgst,btkd->bskgd", torch.softmax(scores, dim=-1), v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int] = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Memory-efficient attention.  A loop over q chunks, each visiting only
    the kv range it can attend to, and over kv chunks with running (max,
    denom, out) statistics in fp32."""
    k, v = _match_kv(q, k, v)
    B, S, KV, G, D = q.shape
    T = k.shape[1]
    if S <= q_chunk and T <= kv_chunk:
        return dense_attention(q, k, v, causal=causal, window=window)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"S={S} T={T} must divide chunks ({q_chunk},{kv_chunk})")
    scale = 1.0 / math.sqrt(D)
    outs = []
    for qi in range(S // q_chunk):
        q_start = qi * q_chunk
        qc = q[:, q_start : q_start + q_chunk].float() * scale
        lo, hi = 0, T
        if causal and S == T:  # self-attention: skip strictly-future blocks
            hi = q_start + q_chunk
        if window is not None:
            lo = max(0, q_start + 1 - window)
        lo = (lo // kv_chunk) * kv_chunk
        hi = -(-hi // kv_chunk) * kv_chunk
        qpos = q_start + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, D), device=q.device)
        for k0 in range(lo, hi, kv_chunk):
            kj, vj = k[:, k0 : k0 + kv_chunk].float(), v[:, k0 : k0 + kv_chunk].float()
            s = torch.einsum("bskgd,btkd->bkgst", qc, kj)
            kpos = k0 + torch.arange(kv_chunk, device=q.device)
            s = torch.where(_keep(qpos, kpos, causal and S == T, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vj)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))  # [B, qc, KV, G, D]
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------


def cache_update(cache_k, cache_v, k_new, v_new, length, rolling: bool):
    """Write k_new/v_new [B, S_new, KV, D] at absolute position ``length`` (an
    int or a 0-d tensor on the cache's device), in place; a rolling buffer
    wraps the write mod its capacity, and a write past an unrolled buffer's
    end is an index error.  Returns (cache_k, cache_v)."""
    idx = length + torch.arange(k_new.shape[1], device=cache_k.device)
    if rolling:
        idx = idx % cache_k.shape[1]
    cache_k.index_copy_(1, idx, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v_new.to(cache_v.dtype))
    return cache_k, cache_v


def _decode_valid(length, S: int, C: int, rolling: bool, device: torch.device) -> torch.Tensor:
    """[S, C] mask of the cache slots each new query sees."""
    slot = torch.arange(C, device=device)
    qpos = length + torch.arange(S, device=device)
    if rolling:
        # slot t holds the newest absolute position p = t (mod C) with
        # p <= newest written; valid for query i iff 0 <= p <= qpos_i
        newest = length + S - 1
        pos = newest - torch.remainder(newest - slot[None, :], C)
        return (pos >= 0) & (pos <= qpos[:, None])
    return slot[None, :] <= qpos[:, None]


def decode_attention(q, cache_k, cache_v, length, *, rolling: bool = False):
    """Attention for S new tokens against a cache they were just written to.

    q grouped [B, S, KV, G, D] (or flat [B, S, H, 1, D]) at absolute
    positions length..length+S-1; cache_k/v [B, C, KV, D].  For rolling
    caches only S == 1 is exact here (use :func:`decode_attention_concat`
    for a chunk).  A flat q is regrouped under its kv heads, which gives the
    numbers of ``_match_kv``'s broadcast without copying the cache per head."""
    shape = q.shape
    B, S, KVq, G, D = shape
    KV = cache_k.shape[2]
    if KVq != KV:
        q = q.reshape(B, S, KV, KVq // KV, D)
    C = cache_k.shape[1]
    qg = q.float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bskgd,btkd->bkgst", qg, cache_k.float())
    s = torch.where(_decode_valid(length, S, C, rolling, q.device), s, NEG_INF)
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(s, dim=-1), cache_v.float())
    return o.to(q.dtype).reshape(shape)


def decode_attention_concat(q, cache_k, cache_v, k_new, v_new, length):
    """Chunked-prefill attention for a rolling cache: attend against the
    pre-write buffer ++ the fresh chunk, so every query in the chunk sees its
    full window even where the chunk's write will evict old slots.
    cache_k/v [B, W, KV, D] is the buffer BEFORE the chunk's write."""
    cache_k, cache_v = _match_kv(q, cache_k, cache_v)
    k_new, v_new = _match_kv(q, k_new, v_new)
    S, D = q.shape[1], q.shape[-1]
    W = cache_k.shape[1]
    qpos = length + torch.arange(S, device=q.device)
    slot = torch.arange(W, device=q.device)
    pos_old = (length - 1) - torch.remainder((length - 1) - slot[None, :], W)
    valid_old = (pos_old >= 0) & (pos_old > qpos[:, None] - W)
    valid_new = qpos[None, :] <= qpos[:, None]  # the window bound is free: S <= W
    kk = torch.cat([cache_k, k_new.to(cache_k.dtype)], dim=1)
    vv = torch.cat([cache_v, v_new.to(cache_v.dtype)], dim=1)
    valid = torch.cat([valid_old, valid_new], dim=1)  # [S, W+S]
    qg = q.float() * (1.0 / math.sqrt(D))
    s = torch.where(valid, torch.einsum("bskgd,btkd->bkgst", qg, kk.float()), NEG_INF)
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(s, dim=-1), vv.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# top-level dispatch
# ---------------------------------------------------------------------------


def pick_chunk(n: int, target: int = 1024) -> int:
    """Largest divisor of n that is <= target."""
    if n <= target:
        return n
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_chunk: int = 1024,
           kv_chunk: int = 1024, kernel: str = "cuda"):
    """Prefill attention entry point.  ``kernel="cuda"``: the flash_attn
    wrapper (the CUDA kernel on CUDA tensors, never a fallback; its plain
    version on CPU tensors); ``kernel="torch"``: :func:`chunked_attention`."""
    if kernel == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window)
    if kernel != "torch":
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    q_chunk = pick_chunk(q.shape[1], q_chunk)
    kv_chunk = pick_chunk(k.shape[1], kv_chunk)
    return chunked_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)


def output_proj(p: dict, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    """o [B,S,KV,G,D] (or flat) -> [B,S,d]."""
    return torch.einsum("bskgh,kghd->bsd", o, p["wo"].to(o.dtype))
