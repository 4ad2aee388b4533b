"""Public wrappers of the flash attention forward.

* :func:`flash_attention_fused` takes the kernel layout (q [BH, S, D], k/v
  [BH / group, T, D]).  On CUDA tensors it launches the hand-written kernel
  (``csrc/flash_attn.cu``) and counts the launch in
  ``flash_attention_fused.launches``; on CPU tensors it runs the plain
  version (``ref.py``).  Any other input raises; there is no fallback from
  the kernel.
* :func:`flash_attention` takes the model layout of
  ``repro/models/attention.py::attend``: q grouped [B, S, KV, G, D] or flat
  [B, S, H, 1, D], k/v [B, T, KV, D], and returns q's layout.  A flat q is
  regrouped to [B, S, KV, H / KV, D] first, so head h reads kv head
  h // (H / KV) as ``_match_kv`` defines (``repro/kernels/flash_attn/ops.py``
  takes q's KV axis for k's and would index past the kv rows here).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attn.ref import flash_attention_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128  # the kernel keeps a row's q and accumulator, D padded to 16s, in registers
_MAX_GRID_Y = 65535  # one grid row per (batch, head)


def _library():
    lib = kernels.load_library("flash_attn")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forward.argtypes = [vp] * 4 + [ci] * 8 + [ctypes.c_float, vp]
        lib.flash_attn_forward.restype = ci
        lib.flash_attn_error_string.argtypes = [ci]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_cuda_inputs(q, k, v, group: int):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected q [BH,S,D], k/v [BKV,T,D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    if k.shape != (BKV, T, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if BKV * group != BH:
        raise ValueError(f"q has {BH} rows, k/v {BKV} rows and group={group}: need BH == BKV * group")
    if min(S, T, D) < 1:
        raise ValueError(f"empty dimension in S={S} T={T} D={D}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}: the flash_attn kernel takes D up to {MAX_HEAD_DIM}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"{BH} (batch x head) rows exceed the kernel's grid ({_MAX_GRID_Y})")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads 16 bytes at a time)")


def _launch(q, k, v, causal: bool, window, group: int):
    _check_cuda_inputs(q, k, v, group)
    BH, S, D = q.shape
    T = k.shape[1]
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, T, D, group, int(causal),
            0 if window is None else int(window), _DTYPE_CODES[q.dtype], D**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn launch failed: {lib.flash_attn_error_string(err).decode()} ({err})")
    flash_attention_fused.launches += 1
    return out


def flash_attention_fused(q, k, v, *, causal: bool = True, window=None, group: int = 1):
    """q [BH,S,D], k/v [BH/group,T,D] -> [BH,S,D] in q's dtype (kernel layout).
    bf16 with D a multiple of 16 runs the tensor-core kernel; fp32 and other D
    the fp32-FMA kernel (both hand-written)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fused runs on CUDA (kernel) or CPU (plain version), not {q.device}")
    return _launch(q, k, v, causal, window, group)


flash_attention_fused.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Model layout: q [B,S,KV,G,D] (grouped) or [B,S,H,1,D] (flat), k/v
    [B,T,KV,D] -> attention output in q's layout."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,KV,G,D], k/v [B,T,KV,D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    shape = q.shape
    B, S, KVq, G, D = shape
    T, KV = k.shape[1], k.shape[2]
    if KVq != KV:  # flat layout: regroup the H query heads under their kv heads
        if G != 1 or KVq % KV:
            raise ValueError(f"q {tuple(shape)} has neither k's {KV} kv heads nor a flat [.., H, 1, D] layout")
        G = KVq // KV
        q = q.reshape(B, S, KV, G, D)
    # .contiguous(): at B == 1 the reshape of the permuted tensor is a strided view
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, T, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, T, D).contiguous()
    of = flash_attention_fused(qf, kf, vf, causal=causal, window=window, group=G)
    return of.reshape(B, KV, G, S, D).permute(0, 3, 1, 2, 4).reshape(shape)
