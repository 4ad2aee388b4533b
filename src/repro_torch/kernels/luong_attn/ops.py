"""Public wrapper of the fused Luong attention head (paper eq. 1-4).

``luong_attention_fused`` is a ``torch.autograd.Function``.  Its forward
launches one of the hand-written CUDA kernel sets of ``csrc/luong_attn.cu``
for CUDA tensors, the one :func:`pick_route` names (or the caller's
``route``), and runs the plain version (``ref.py``) for CPU tensors; any
other input raises.  There is no fallback from a kernel: a route that does
not fit the inputs raises, on either device.

Routes (``ROUTES``), by the rows R = B*N and the width h:
  "decode": bf16, h a multiple of 64 up to 1024, R <= 32: one cooperative
            launch (a serving decode tick);
  "wgmma":  bf16, h a multiple of 64 up to 2048: three launches, the weight
            products on the tensor cores (the training step's 2048 rows);
  "fma":    fp32, and bf16 at other widths: the first kernel's five FMA launches.
Each call counts once in ``luong_attention_fused.launches``, once in
``luong_attention_fused.launches_by_route[route]`` and once in
``luong_attention_fused.launches_by_shape[(route, B, N)]``.

Its backward is the recompute of ``repro/kernels/luong_attn/ops.py``: the
head is rebuilt with the plain version from the saved inputs (no activation
stash) and its vector-Jacobian product taken; the mask gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.luong_attn.ref import luong_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DYNAMIC_SMEM = 48 * 1024  # "fma": the scores kernel's q [h] and the context kernel's scores [M], fp32
_MAX_GRID_Y = 65535  # "fma": the scores and context kernels put one row of B*N per grid row
# the "decode" kernel keeps [rows, h] of C in shared memory; it is faster than "wgmma" up to there
# (tools/luong_attn_variants.py at R = 4, 16, 32: PERF.md)
DECODE_MAX_ROWS = 32
DECODE_MAX_H = 1024  # h / 8 blocks, each holding 8 columns of the three weights, must all be resident
WGMMA_MAX_H = 2048  # the context kernel keeps 8 rows of Q [8, h] fp32 in shared memory
# The kernel sets of csrc/luong_attn.cu, by the code the entry point takes
ROUTES = {"fma": 0, "wgmma": 1, "decode": 2}
_barriers: dict = {}  # device index -> the "decode" route's grid-barrier words (arrivals, this call's start)


def _library():
    lib = kernels.load_library("luong_attn")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.luong_attn_forward.argtypes = [vp] * 9 + [ci] * 6 + [vp]
        lib.luong_attn_forward.restype = ci
        lib.luong_attn_scratch_floats.argtypes = [ci] * 5
        lib.luong_attn_scratch_floats.restype = ctypes.c_longlong
        lib.luong_attn_error_string.argtypes = [ci]
        lib.luong_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def route_fits(route: str, dtype: torch.dtype, h: int, R: int) -> bool:
    """Whether kernel set ``route`` takes R = B*N rows of width h in ``dtype``."""
    wide = dtype == torch.bfloat16 and h % 64 == 0
    if route == "decode":
        return wide and h <= DECODE_MAX_H and R <= DECODE_MAX_ROWS
    if route == "wgmma":
        return wide and h <= WGMMA_MAX_H
    return route == "fma"


def pick_route(dtype: torch.dtype, h: int, R: int) -> str:
    """The kernel set for these inputs: decode (R <= 32), then wgmma, then fma."""
    return next(r for r in ("decode", "wgmma", "fma") if route_fits(r, dtype, h, R))


def _route(H, route):
    """``route``, checked against H's dtype and shape, or the pick."""
    B, N, h = H.shape
    if route is None:
        return pick_route(H.dtype, h, B * N)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)} or None, got {route!r}")
    if not route_fits(route, H.dtype, h, B * N):
        raise ValueError(f"the {route!r} route does not take {H.dtype} at h={h} with {B * N} rows")
    return route


def _check_inputs(H, S, mask, w_alpha, w_c):
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


def _check_cuda_inputs(H, S, mask, w_alpha, w_c, route):
    B, N, h = H.shape
    M = S.shape[1]
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
        if route != "fma" and t is not mask and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the {route!r} kernels copy 16 bytes at a time)")
    if route == "fma":
        if max(h, M) * 4 > _MAX_DYNAMIC_SMEM:
            raise ValueError(f"h={h} or M={M} exceeds the kernels' shared-memory budget ({_MAX_DYNAMIC_SMEM // 4})")
        if B * N > _MAX_GRID_Y or B * N * h >= 2**31:
            raise ValueError(f"B*N={B * N} rows of width {h} exceed the kernels' grid")
    elif B > _MAX_GRID_Y or B * max(N, M) * h >= 2**31:
        raise ValueError(f"B={B}, N={N}, M={M} at width {h} exceed the {route!r} kernels' grid or indexing")


def _barrier(device) -> torch.Tensor:
    """The "decode" route's grid-barrier words on ``device``: zero when made, then kept by
    the kernel (the arrival count runs on across calls; the second word holds where the
    next call begins).  Calls on one device share them, so they run one at a time."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    buf = _barriers.get(index)
    if buf is None:
        buf = _barriers[index] = torch.zeros(2, dtype=torch.int32, device=device)
    return buf


def scratch_bytes(B: int, N: int, M: int, h: int, route: str) -> int:
    """Bytes of scratch one call on ``route`` allocates."""
    return int(_library().luong_attn_scratch_floats(B, N, M, h, ROUTES[route])) * 4


def _launch(H, S, src_mask, w_alpha, w_c, route):
    _check_inputs(H, S, src_mask, w_alpha, w_c)
    route = _route(H, route)
    _check_cuda_inputs(H, S, src_mask, w_alpha, w_c, route)
    B, N, h = H.shape
    M = S.shape[1]
    lib = _library()
    with torch.cuda.device(H.device):
        mask = src_mask.to(torch.int32)  # the TPU kernel's astype(int32)
        n = lib.luong_attn_scratch_floats(B, N, M, h, ROUTES[route])
        scratch = torch.empty(n, dtype=torch.float32, device=H.device)
        barrier = _barrier(H.device).data_ptr() if route == "decode" else None
        out = torch.empty_like(H)
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.luong_attn_forward(
            H.data_ptr(), S.data_ptr(), mask.data_ptr(), w_alpha.data_ptr(), w_c.data_ptr(), w_c[h:].data_ptr(),
            out.data_ptr(), scratch.data_ptr(), barrier, B, N, M, h, _DTYPE_CODES[H.dtype], ROUTES[route], stream,
        )
    if err != 0:
        raise RuntimeError(f"luong_attn launch ({route}) failed: {lib.luong_attn_error_string(err).decode()} ({err})")
    luong_attention_fused.launches += 1
    luong_attention_fused.launches_by_route[route] += 1
    key = (route, B, N)
    luong_attention_fused.launches_by_shape[key] = luong_attention_fused.launches_by_shape.get(key, 0) + 1
    return out


def _plain(H, S, src_mask, w_alpha, w_c):
    h = H.shape[-1]
    return luong_attention_ref(H, S, src_mask, w_alpha, w_c[:h], w_c[h:])


class _LuongHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, S, src_mask, w_alpha, w_c, route):
        ctx.save_for_backward(H, S, src_mask, w_alpha, w_c)
        if H.device.type == "cpu":
            _check_inputs(H, S, src_mask, w_alpha, w_c)
            _route(H, route)
            return _plain(H, S, src_mask, w_alpha, w_c)
        return _launch(H, S, src_mask, w_alpha, w_c, route)

    @staticmethod
    def backward(ctx, dHc):
        H, S, src_mask, w_alpha, w_c = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (H, S, w_alpha, w_c)]
            out = _plain(ins[0], ins[1], src_mask, ins[2], ins[3])
            dH, dS, dwa, dwc = torch.autograd.grad(out, ins, dHc)
        need = ctx.needs_input_grad
        return (dH if need[0] else None, dS if need[1] else None, None, dwa if need[3] else None,
                dwc if need[4] else None, None)


def luong_attention_fused(H, S, src_mask, w_alpha, w_c, *, route=None):
    """H [B,N,h], S [B,M,h], src_mask [B,M], w_alpha [h,h], w_c [2h,h]
    (the paper's layout: tanh(W_c [H; C])) -> Hc [B,N,h] in H's dtype.
    ``route`` None runs :func:`pick_route`'s kernels; a named route that does
    not fit raises.  Differentiable through the recompute backward."""
    if H.device.type not in ("cpu", "cuda"):
        raise ValueError(f"luong_attention_fused runs on CUDA (kernel) or CPU (plain version), not {H.device}")
    return _LuongHead.apply(H, S, src_mask, w_alpha, w_c, route)


luong_attention_fused.launches = 0
luong_attention_fused.launches_by_route = dict.fromkeys(ROUTES, 0)
luong_attention_fused.launches_by_shape = {}


def reset_launches():
    """Set the launch counts (total, per route and per shape) to 0."""
    luong_attention_fused.launches = 0
    luong_attention_fused.launches_by_route = dict.fromkeys(ROUTES, 0)
    luong_attention_fused.launches_by_shape = {}
