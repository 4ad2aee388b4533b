"""Public wrapper of the grouped expert FFN (the gated MoE expert GEMM).

:func:`moe_gemm_fused` takes the layout of ``repro/kernels/moe_gemm/ops.py``:
x [E, C, d] (the dispatch buffer), w1/wg [E, d, F], w2 [E, F, d], and
returns [E, C, d] in x's dtype.  ``rows`` (int32 [E], optional) says how
many leading rows of each expert's group hold a slot; the rows past it come
back exactly zero whatever x holds there, and no product is spent on them.
On CUDA tensors it launches one pair of the hand-written kernels of
``csrc/moe_gemm.cu`` (a gate-up launch into an ``h`` scratch [E, C, F] that
this wrapper allocates, then a down launch), the pair :func:`pick_route`
names or the caller's ``route``, and counts the call in
``moe_gemm_fused.launches`` and ``moe_gemm_fused.launches_by_route``; on CPU
tensors it runs the plain version (``ref.py``).  A route that does not fit
the inputs raises, on either device; any other input raises; there is no
fallback from a kernel.  It is differentiable in x, w1, wg and w2: the
backward recomputes the forward through the plain version in fp32 and takes
its grads (in the inputs' dtypes; x's rows past ``rows[e]`` get exactly
zero), as the JAX package's model trains on its plain expert FFN (its
Pallas wrapper has no VJP).  Only forward launches are counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_ROWS = 16  # the decode route's row tile: mma.sync's M
WGMMA_MAX_EXPERTS = 256  # the wgmma route keeps per-expert prefix sums in shared memory
# The kernel pairs of csrc/moe_gemm.cu, by the code the entry point takes:
#   "wgmma":  bf16, d and F multiples of 64 (the prefill's: persistent, TMA-fed wgmma)
#   "decode": bf16, d and F multiples of 64, C <= 16 (the decode step's: bytes-bound, skips empty experts)
#   "mma":    bf16, d and F multiples of 8 (mma.sync on 64 x 64 tiles)
#   "fma":    fp32 or bf16, any width (fp32 FMA, h in fp32)
ROUTES = {"fma": 0, "mma": 1, "wgmma": 2, "decode": 3}


def _library():
    lib = kernels.load_library("moe_gemm")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm_forward.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.moe_gemm_forward.restype = ci
        lib.moe_gemm_error_string.argtypes = [ci]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def route_fits(route: str, dtype: torch.dtype, E: int, C: int, d: int, F: int) -> bool:
    """Whether kernel pair ``route`` takes x [E, C, d] of ``dtype`` with experts of width F."""
    wide = dtype == torch.bfloat16 and d % 64 == 0 and F % 64 == 0
    if route == "wgmma":
        return wide and E <= WGMMA_MAX_EXPERTS
    if route == "decode":
        return wide and C <= DECODE_MAX_ROWS
    if route == "mma":
        return dtype == torch.bfloat16 and d % 8 == 0 and F % 8 == 0
    return route == "fma"


def pick_route(dtype: torch.dtype, E: int, C: int, d: int, F: int) -> str:
    """The kernel pair for these inputs: decode (C <= 16), then wgmma, mma, fma."""
    return next(r for r in ("decode", "wgmma", "mma", "fma") if route_fits(r, dtype, E, C, d, F))


def _route(x, w1, route):
    """``route``, checked against the inputs, or the pick."""
    E, C, d = x.shape
    F = w1.shape[-1]
    if route is None:
        return pick_route(x.dtype, E, C, d, F)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)} or None, got {route!r}")
    if not route_fits(route, x.dtype, E, C, d, F):
        raise ValueError(f"the {route!r} kernels do not take {x.dtype} at E={E} C={C} d={d} F={F}")
    return route


def _check_inputs(x, w1, wg, w2, rows):
    if x.dim() != 3 or w1.dim() != 3:
        raise ValueError(f"expected x [E,C,d], w1/wg [E,d,F], w2 [E,F,d]; got {tuple(x.shape)}, {tuple(w1.shape)}")
    E, C, d = x.shape
    F = w1.shape[2]
    if tuple(w1.shape) != (E, d, F) or tuple(wg.shape) != (E, d, F) or tuple(w2.shape) != (E, F, d):
        raise ValueError(f"w1 {tuple(w1.shape)}, wg {tuple(wg.shape)}, w2 {tuple(w2.shape)} do not match x "
                         f"{tuple(x.shape)}: need w1/wg [E,d,F] and w2 [E,F,d]")
    if min(E, C, d, F) < 1:
        raise ValueError(f"empty dimension in E={E} C={C} d={d} F={F}")
    if rows is not None:
        if rows.dtype != torch.int32 or tuple(rows.shape) != (E,):
            raise ValueError(f"rows must be int32 [E={E}], got {rows.dtype} {tuple(rows.shape)}")
        if rows.device != x.device:
            raise ValueError(f"rows is on {rows.device}, x is on {x.device}")


def _check_cuda_inputs(x, w1, wg, w2, rows):
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
    if rows is not None and not rows.is_contiguous():
        raise ValueError("rows must be contiguous")


def _launch(x, w1, wg, w2, rows, route):
    _check_inputs(x, w1, wg, w2, rows)
    route = _route(x, w1, route)
    _check_cuda_inputs(x, w1, wg, w2, rows)
    E, C, d = x.shape
    F = w1.shape[2]
    lib = _library()
    with torch.cuda.device(x.device):
        h = torch.empty((E, C, F), dtype=torch.float32 if route == "fma" else torch.bfloat16, device=x.device)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gemm_forward(x.data_ptr(), w1.data_ptr(), wg.data_ptr(), w2.data_ptr(), h.data_ptr(),
                                   out.data_ptr(), None if rows is None else rows.data_ptr(), E, C, d, F,
                                   _DTYPE_CODES[x.dtype], ROUTES[route], stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch ({route}) failed: {lib.moe_gemm_error_string(err).decode()} ({err})")
    moe_gemm_fused.launches += 1
    moe_gemm_fused.launches_by_route[route] += 1
    return out


class _MoeGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, wg, w2, rows, route):
        ctx.save_for_backward(x, w1, wg, w2, rows)
        if x.device.type == "cpu":
            _check_inputs(x, w1, wg, w2, rows)
            _route(x, w1, route)
            return moe_gemm_plain(x, w1, wg, w2, rows)
        return _launch(x, w1, wg, w2, rows, route)

    @staticmethod
    def backward(ctx, dout):
        x, w1, wg, w2, rows = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, w1, wg, w2)]
            out = moe_gemm_plain(*ins, rows)
            grads = torch.autograd.grad(out, ins, dout)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None, None)


def moe_gemm_fused(x, w1, wg, w2, rows=None, *, route=None):
    """x [E,C,d], w1/wg [E,d,F], w2 [E,F,d] -> [E,C,d] in x's dtype: each
    expert's gated FFN over its rows; with ``rows`` (int32 [E]) over its
    first ``rows[e]`` rows, the others exactly zero.  ``route`` None runs
    :func:`pick_route`'s kernels: bf16 with d and F multiples of 64 the
    "decode" pair at C <= 16 and the "wgmma" pair above; bf16 at other
    multiples of 8 the "mma" pair; fp32 and other widths the "fma" pair
    (all hand-written; every route but "fma" rounds ``h`` to bf16 between
    the products).  A named route that does not fit raises.  Differentiable
    in x and the weights through the recompute backward."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_gemm_fused runs on CUDA (kernel) or CPU (plain version), not {x.device}")
    return _MoeGemm.apply(x, w1, wg, w2, rows, route)


moe_gemm_fused.launches = 0
moe_gemm_fused.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches():
    """Set the launch counts (total and per route) to 0."""
    moe_gemm_fused.launches = 0
    moe_gemm_fused.launches_by_route = dict.fromkeys(ROUTES, 0)
