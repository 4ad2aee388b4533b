"""Public wrapper of the fused Luong attention head (paper eq. 1-4).

``luong_attention_fused`` launches the hand-written CUDA kernel
(``csrc/luong_attn.cu``) for CUDA tensors and runs the plain version
(``ref.py``) for CPU tensors; any other input raises.  There is no fallback
from the kernel: a CUDA input that the kernel does not take raises.

Inference only for now: an input that requires grad raises (the recompute
backward of ``repro/kernels/luong_attn/ops.py`` arrives with the training
slice).  ``luong_attention_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.luong_attn.ref import luong_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DYNAMIC_SMEM = 48 * 1024  # the scores kernel's q [h] and the context kernel's scores [M], fp32
_MAX_GRID_Y = 65535  # the scores and context kernels put one row of B*N per grid row


def _library():
    lib = kernels.load_library("luong_attn")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.luong_attn_forward.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.luong_attn_forward.restype = ci
        lib.luong_attn_scratch_floats.argtypes = [ci] * 4
        lib.luong_attn_scratch_floats.restype = ctypes.c_longlong
        lib.luong_attn_error_string.argtypes = [ci]
        lib.luong_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_cuda_inputs(H, S, mask, w_alpha, w_c):
    if H.dim() != 3 or S.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"expected H [B,N,h], S [B,M,h], src_mask [B,M]; got {tuple(H.shape)}, {tuple(S.shape)}, "
                         f"{tuple(mask.shape)}")
    B, N, h = H.shape
    M = S.shape[1]
    if S.shape != (B, M, h) or mask.shape != (B, M):
        raise ValueError(f"S {tuple(S.shape)} / src_mask {tuple(mask.shape)} do not match H {tuple(H.shape)}")
    if w_alpha.shape != (h, h) or w_c.shape != (2 * h, h):
        raise ValueError(f"w_alpha {tuple(w_alpha.shape)} / w_c {tuple(w_c.shape)} must be [{h},{h}] / [{2 * h},{h}]")
    if min(B, N, M, h) < 1:
        raise ValueError(f"empty dimension in B={B} N={N} M={M} h={h}")
    if H.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {H.dtype}")
    for name, t in (("S", S), ("w_alpha", w_alpha), ("w_c", w_c)):
        if t.dtype != H.dtype:
            raise TypeError(f"{name} is {t.dtype}, H is {H.dtype}")
    if mask.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"src_mask must be bool or int32, got {mask.dtype}")
    for name, t in (("H", H), ("S", S), ("src_mask", mask), ("w_alpha", w_alpha), ("w_c", w_c)):
        if t.device != H.device:
            raise ValueError(f"{name} is on {t.device}, H is on {H.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(h, M) * 4 > _MAX_DYNAMIC_SMEM:
        raise ValueError(f"h={h} or M={M} exceeds the kernels' shared-memory budget ({_MAX_DYNAMIC_SMEM // 4})")
    if B * N > _MAX_GRID_Y or B * N * h >= 2**31:
        raise ValueError(f"B*N={B * N} rows of width {h} exceed the kernels' grid")


def _launch(H, S, src_mask, w_alpha, w_c):
    _check_cuda_inputs(H, S, src_mask, w_alpha, w_c)
    B, N, h = H.shape
    M = S.shape[1]
    lib = _library()
    with torch.cuda.device(H.device):
        mask = src_mask.to(torch.int32)  # the TPU kernel's astype(int32)
        scratch = torch.empty(lib.luong_attn_scratch_floats(B, N, M, h), dtype=torch.float32, device=H.device)
        out = torch.empty_like(H)
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.luong_attn_forward(
            H.data_ptr(), S.data_ptr(), mask.data_ptr(), w_alpha.data_ptr(), w_c.data_ptr(), w_c[h:].data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, N, M, h, _DTYPE_CODES[H.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"luong_attn launch failed: {lib.luong_attn_error_string(err).decode()} ({err})")
    luong_attention_fused.launches += 1
    return out


def luong_attention_fused(H, S, src_mask, w_alpha, w_c):
    """H [B,N,h], S [B,M,h], src_mask [B,M], w_alpha [h,h], w_c [2h,h]
    (the paper's layout: tanh(W_c [H; C])) -> Hc [B,N,h] in H's dtype."""
    if any(t.requires_grad for t in (H, S, w_alpha, w_c)):
        raise NotImplementedError("luong_attention_fused is inference-only: its backward is not ported yet")
    h = H.shape[-1]
    if H.device.type == "cpu":
        return luong_attention_ref(H, S, src_mask, w_alpha, w_c[:h], w_c[h:])
    if H.device.type != "cuda":
        raise ValueError(f"luong_attention_fused runs on CUDA (kernel) or CPU (plain version), not {H.device}")
    return _launch(H, S, src_mask, w_alpha, w_c)


luong_attention_fused.launches = 0
