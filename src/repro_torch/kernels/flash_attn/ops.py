"""Public wrappers of flash attention.

* :func:`flash_attention_fused` takes the kernel layout (q [BH, S, D], k/v
  [BH / group, T, D]).  On CUDA tensors it launches one of the hand-written
  kernels of ``csrc/flash_attn.cu``, the one :func:`pick_route` names (or the
  caller's ``route``), and counts the launch in
  ``flash_attention_fused.launches`` and in
  ``flash_attention_fused.launches_by_route``; on CPU tensors it runs the
  plain version (``ref.py``).  A route that does not fit the inputs raises,
  on either device; any other input raises; there is no fallback from a
  kernel.  It is differentiable: the backward recomputes the forward through
  the plain version in fp32, on blocks of ``BACKWARD_BLOCK`` rows and keys
  (the JAX model's training chunks), and takes its grads (dq, dk, dv in the
  inputs' dtypes), as the JAX package's model trains on its plain chunked
  attention (its Pallas wrapper has no VJP).  Only forward launches are
  counted.
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
MAX_HEAD_DIM = 128  # the kernels keep a row's q and accumulator, D padded to 16s, in registers
_MAX_GRID_Y = 65535  # one grid row per (batch, head)
# The kernels of csrc/flash_attn.cu, by the code the entry point takes:
#   "wgmma": bf16, D = 64 or 128 (Hopper's warpgroup tensor cores, TMA-fed)
#   "mma":   bf16, D a multiple of 16 (mma.sync tensor cores)
#   "fma":   fp32 or bf16, any D (fp32 FMA)
ROUTES = {"fma": 0, "mma": 1, "wgmma": 2}
# the recompute backward's q and kv blocks: the JAX model trains on chunks of 1024 (RunCtx.q_chunk and
# kv_chunk); at S=2048 the plain version then runs 3 block pairs a head group, not 36 of 256, so the host
# enqueues a twelfth of the small ops (with 256 the LM training step waits on the host)
BACKWARD_BLOCK = 1024


def _library():
    lib = kernels.load_library("flash_attn")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_forward.argtypes = [vp] * 4 + [ci] * 9 + [ctypes.c_float, vp]
        lib.flash_attn_forward.restype = ci
        lib.flash_attn_error_string.argtypes = [ci]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def route_fits(route: str, dtype: torch.dtype, D: int) -> bool:
    """Whether kernel ``route`` takes inputs of ``dtype`` and head dim ``D``."""
    if route == "wgmma":
        return dtype == torch.bfloat16 and D in (64, 128)
    if route == "mma":
        return dtype == torch.bfloat16 and D % 16 == 0
    return route == "fma"


def pick_route(dtype: torch.dtype, D: int) -> str:
    """The fastest kernel that takes (dtype, D): wgmma, then mma, then fma."""
    return next(r for r in ("wgmma", "mma", "fma") if route_fits(r, dtype, D))


def _route(q, route):
    """``route``, checked against q's dtype and head dim, or the pick."""
    D = q.shape[-1]
    if route is None:
        return pick_route(q.dtype, D)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)} or None, got {route!r}")
    if not route_fits(route, q.dtype, D):
        raise ValueError(f"the {route!r} kernel does not take {q.dtype} at head_dim {D}")
    return route


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


def _launch(q, k, v, causal: bool, window, group: int, route: str):
    _check_cuda_inputs(q, k, v, group)
    BH, S, D = q.shape
    T = k.shape[1]
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, T, D, group, int(causal),
            0 if window is None else int(window), _DTYPE_CODES[q.dtype], ROUTES[route], D**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn launch ({route}) failed: {lib.flash_attn_error_string(err).decode()} ({err})")
    flash_attention_fused.launches += 1
    flash_attention_fused.launches_by_route[route] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, group, route):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, group=group)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, **ctx.args)
        return _launch(q, k, v, causal, window, group, route)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*ins, **ctx.args, block_q=BACKWARD_BLOCK, block_kv=BACKWARD_BLOCK)
            grads = torch.autograd.grad(out, ins, do)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None, None, None, None)


def flash_attention_fused(q, k, v, *, causal: bool = True, window=None, group: int = 1, route=None):
    """q [BH,S,D], k/v [BH/group,T,D] -> [BH,S,D] in q's dtype (kernel layout).
    ``route`` None runs :func:`pick_route`'s kernel: bf16 at D = 64 or 128 the
    wgmma kernel, bf16 at other multiples of 16 the mma.sync kernel, fp32 and
    other D the fp32-FMA kernel (all hand-written).  A named route that does
    not fit q's dtype and D raises.  Differentiable through the recompute
    backward."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    route = _route(q, route)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_fused runs on CUDA (kernel) or CPU (plain version), not {q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, group, route)


flash_attention_fused.launches = 0
flash_attention_fused.launches_by_route = dict.fromkeys(ROUTES, 0)


def reset_launches():
    """Set the launch counts (total and per route) to 0."""
    flash_attention_fused.launches = 0
    flash_attention_fused.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Model layout: q [B,S,KV,G,D] (grouped) or [B,S,H,1,D] (flat), k/v
    [B,T,KV,D] -> attention output in q's layout; differentiable."""
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
