"""Public wrapper of the grouped expert FFN (the gated MoE expert GEMM).

:func:`moe_gemm_fused` takes the layout of ``repro/kernels/moe_gemm/ops.py``:
x [E, C, d] (the dispatch buffer), w1/wg [E, d, F], w2 [E, F, d], and
returns [E, C, d] in x's dtype.  On CUDA tensors it launches the
hand-written kernel (``csrc/moe_gemm.cu``: a gate-up launch into an ``h``
scratch [E, C, F] that this wrapper allocates, then a down launch) and
counts the call in ``moe_gemm_fused.launches``; on CPU tensors it runs the
plain version (``ref.py``).  Any other input raises; there is no fallback
from the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    lib = kernels.load_library("moe_gemm")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm_forward.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.moe_gemm_forward.restype = ci
        lib.moe_gemm_h_is_bf16.argtypes = [ci] * 3
        lib.moe_gemm_h_is_bf16.restype = ci
        lib.moe_gemm_error_string.argtypes = [ci]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_cuda_inputs(x, w1, wg, w2):
    if x.dim() != 3 or w1.dim() != 3:
        raise ValueError(f"expected x [E,C,d], w1/wg [E,d,F], w2 [E,F,d]; got {tuple(x.shape)}, {tuple(w1.shape)}")
    E, C, d = x.shape
    F = w1.shape[2]
    if tuple(w1.shape) != (E, d, F) or tuple(wg.shape) != (E, d, F) or tuple(w2.shape) != (E, F, d):
        raise ValueError(f"w1 {tuple(w1.shape)}, wg {tuple(wg.shape)}, w2 {tuple(w2.shape)} do not match x "
                         f"{tuple(x.shape)}: need w1/wg [E,d,F] and w2 [E,F,d]")
    if min(E, C, d, F) < 1:
        raise ValueError(f"empty dimension in E={E} C={C} d={d} F={F}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("w1", w1), ("wg", wg), ("w2", w2)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")


def _launch(x, w1, wg, w2):
    _check_cuda_inputs(x, w1, wg, w2)
    E, C, d = x.shape
    F = w1.shape[2]
    code = _DTYPE_CODES[x.dtype]
    lib = _library()
    with torch.cuda.device(x.device):
        h_dtype = torch.bfloat16 if lib.moe_gemm_h_is_bf16(code, d, F) else torch.float32
        h = torch.empty((E, C, F), dtype=h_dtype, device=x.device)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gemm_forward(x.data_ptr(), w1.data_ptr(), wg.data_ptr(), w2.data_ptr(), h.data_ptr(),
                                   out.data_ptr(), E, C, d, F, code, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: {lib.moe_gemm_error_string(err).decode()} ({err})")
    moe_gemm_fused.launches += 1
    return out


def moe_gemm_fused(x, w1, wg, w2):
    """x [E,C,d], w1/wg [E,d,F], w2 [E,F,d] -> [E,C,d] in x's dtype: each
    expert's gated FFN over its rows.  bf16 with d and F multiples of 8 runs
    the tensor-core kernels (``h`` rounded to bf16 between the two
    products); fp32, and bf16 at other widths, the fp32-FMA kernels (``h``
    kept in fp32); both hand-written."""
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w1, wg, w2)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm_fused runs on CUDA (kernel) or CPU (plain version), not {x.device}")
    return _launch(x, w1, wg, w2)


moe_gemm_fused.launches = 0
