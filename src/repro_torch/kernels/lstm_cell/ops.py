"""Public wrapper of the fused LSTM cell.

``lstm_cell_fused`` is a ``torch.autograd.Function``.  Its forward launches
the hand-written CUDA kernel (``csrc/lstm_cell.cu``) for CUDA tensors and
runs the plain version (``ref.py``) for CPU tensors; any other input raises,
and a CUDA input that the kernel does not take raises too (there is no
fallback from the kernel).  Its backward is :func:`lstm_cell_adjoint`, the
analytic fp32 adjoint with the gates recomputed from the saved inputs (no
activation stash), as in ``repro/kernels/lstm_cell/ops.py``; the same
Function wraps both devices, so the CPU tests exercise the real backward.
``lstm_cell_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_gates

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 64  # the kernel's row tile; grid rows are at most 65535
_MAX_GRID_Y = 65535


def _library():
    lib = kernels.load_library("lstm_cell")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lstm_cell_forward.argtypes = [vp] * 8 + [ci] * 9 + [vp]
        lib.lstm_cell_forward.restype = ci
        lib.lstm_cell_error_string.argtypes = [ci]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_shapes(x, h, c, wx, wh, b):
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"expected x [B,In], h [B,H]; got {tuple(x.shape)}, {tuple(h.shape)}")
    B, In = x.shape
    H = h.shape[1]
    want = {"h": (B, H), "c": (B, H), "wx": (In, 4, H), "wh": (H, 4, H), "b": (4, H)}
    for name, t in (("h", h), ("c", c), ("wx", wx), ("wh", wh), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} is {tuple(t.shape)}, expected {want[name]} for x {tuple(x.shape)}, h {tuple(h.shape)}"
            )
    if min(B, In, H) < 1:
        raise ValueError(f"empty dimension in B={B} In={In} H={H}")


def _launch(x, h, c, wx, wh, b):
    ins = (("x", x), ("h", h), ("c", c), ("wx", wx), ("wh", wh), ("b", b))
    for name, t in ins:
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the kernel takes float32 or bfloat16, {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, In = x.shape
    H = h.shape[1]
    if -(-B // _ROWS_PER_BLOCK) > _MAX_GRID_Y or max(B * In, B * H, In * 4 * H, H * 4 * H) >= 2**31:
        raise ValueError(f"B={B} In={In} H={H} exceed the kernel's grid or int32 sizes")
    lib = _library()
    with torch.cuda.device(x.device):
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lstm_cell_forward(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), B, In, H, *(_DTYPE_CODES[t.dtype] for _, t in ins), stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_cell launch failed: {lib.lstm_cell_error_string(err).decode()} ({err})")
    lstm_cell_fused.launches += 1
    return h_out, c_out


def lstm_cell_adjoint(x, h, c, wx, wh, b, dh_new, dc_new):
    """Analytic fp32 adjoint of one LSTM cell, gates recomputed from the
    saved inputs (the port of ``repro/kernels/lstm_cell/ops.py::
    lstm_cell_adjoint``).  (x [B, In], h/c [B, H] previous state, dh_new /
    dc_new cotangents of the new state, any dtype) -> fp32 (dx, dh, dc, dwx,
    dwh, db)."""
    In, _, H = wx.shape
    dh_new, dc_new = dh_new.float(), dc_new.float()
    gates = lstm_gates(x, h, wx, wh, b)
    i_s, f_s = torch.sigmoid(gates[:, 0]), torch.sigmoid(gates[:, 1])
    g_t, o_s = torch.tanh(gates[:, 2]), torch.sigmoid(gates[:, 3])
    cf = c.float()
    tc = torch.tanh(f_s * cf + i_s * g_t)
    # dL/dc' takes the direct cotangent and the path through h' = o tanh(c')
    dc_tot = dc_new + dh_new * o_s * (1.0 - tc * tc)
    d_pre = torch.stack(
        [
            dc_tot * g_t * i_s * (1.0 - i_s),  # i gate
            dc_tot * cf * f_s * (1.0 - f_s),  # f gate
            dc_tot * i_s * (1.0 - g_t * g_t),  # g gate
            dh_new * tc * o_s * (1.0 - o_s),  # o gate
        ],
        dim=1,
    ).reshape(-1, 4 * H)  # [B, 4H]
    wx2, wh2 = wx.float().reshape(In, 4 * H), wh.float().reshape(H, 4 * H)
    dx = torch.matmul(d_pre, wx2.t())
    dh = torch.matmul(d_pre, wh2.t())
    dc = dc_tot * f_s
    dwx = torch.matmul(x.float().t(), d_pre).view(In, 4, H)
    dwh = torch.matmul(h.float().t(), d_pre).view(H, 4, H)
    db = d_pre.sum(0).view(4, H)
    return dx, dh, dc, dwx, dwh, db


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        if x.device.type == "cpu":
            return lstm_cell_ref(x, h, c, wx, wh, b)
        return _launch(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        saved = ctx.saved_tensors
        grads = lstm_cell_adjoint(*saved, dh_new, dc_new)
        return tuple(g.to(a.dtype) if need else None for g, a, need in zip(grads, saved, ctx.needs_input_grad))


def lstm_cell_fused(x, h, c, wx, wh, b):
    """x [B, In], h/c [B, H], wx [In, 4, H], wh [H, 4, H], b [4, H], each
    fp32 or bf16 -> (h' in h's dtype, c' in c's dtype).  Differentiable: the
    backward is :func:`lstm_cell_adjoint`, grads in the inputs' dtypes."""
    _check_shapes(x, h, c, wx, wh, b)
    devices = {t.device.type for t in (x, h, c, wx, wh, b)}
    if devices == {"cpu"} or devices == {"cuda"}:
        return _LSTMCell.apply(x, h, c, wx, wh, b)
    raise ValueError(f"lstm_cell_fused runs on CUDA (kernel) or CPU (plain version), not on {sorted(devices)}")


lstm_cell_fused.launches = 0
