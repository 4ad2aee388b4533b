"""Public wrapper of the fused LSTM cell.

``lstm_cell_fused`` is a ``torch.autograd.Function``.  Its forward launches
a hand-written CUDA kernel (``csrc/lstm_cell.cu``) for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors; any other input raises, and a
CUDA input that the kernels do not take raises too (there is no fallback
from a kernel).  Two kernels:

* tensor cores, when x and the weights are bf16 and In and H are multiples
  of 8: the weights go to it packed (:func:`pack_weights`), h may be fp32
  (split in the kernel into two bf16 terms, so it is not rounded) or bf16;
* fp32 FMA, every other feed (fp32 weights, ragged widths).

Both take the TPU kernel's column tile as well as the whole cell: h
``[B, H_in]`` whole, c ``[B, Hs]``, wx ``[In, 4, Hs]``, wh ``[H_in, 4,
Hs]``, b ``[4, Hs]`` give h', c' ``[B, Hs]``, the gates of Hs units of a
cell of H_in (the tensor-parallel backbone's shard; Hs = H_in is the whole
cell).  A shard's output is the same columns of the whole cell's, bit for
bit, on either kernel.

``lstm_cell_fused.launches`` counts kernel launches,
``lstm_cell_fused.mma_launches`` and ``lstm_cell_fused.fma_launches`` those
of each kernel, and ``lstm_cell_fused.launches_by_shape[(kernel, In, Hs)]``
those of each kernel (``"mma"`` or ``"fma"``) at each depth In and width Hs;
:func:`reset_launches` sets them all to 0.

The weights a cell computes with are a :class:`CellWeights`.  A layer call
makes them once with :func:`cast_weights` and passes them to every step
(``weights=``): the cast to the compute dtype and the packing then happen
once per layer call, not once per timestep, and the differentiable
arguments ``wx, wh, b`` are the fp32 masters, whose grads autograd sums over
the timesteps in fp32.  Called without ``weights``, the cell computes with
its arguments as given and returns grads in their dtypes.

The backward is :func:`lstm_cell_adjoint`, the analytic fp32 adjoint with
the gates recomputed from the saved inputs (no activation stash), as in
``repro/kernels/lstm_cell/ops.py``, on the values the forward used; the
same Function wraps both devices, so the CPU tests exercise the real
backward.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_gates

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 64  # both kernels' row tile; grid rows are at most 65535
_MAX_GRID_Y = 65535
_GRANULE = 8  # hidden units per granule of the packed weights
_CHUNK = 64  # depth of the tensor-core kernel's chunks


def _library():
    lib = kernels.load_library("lstm_cell")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lstm_cell_forward.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        lib.lstm_cell_forward.restype = ci
        lib.lstm_cell_forward_mma.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        lib.lstm_cell_forward_mma.restype = ci
        lib.lstm_cell_error_string.argtypes = [ci]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


class CellWeights(NamedTuple):
    """The weights one cell computes with, detached from autograd."""

    wx: torch.Tensor  # [In, 4, Hs]: the values of the products (fp32 copies of the rounded weights on a bf16 feed)
    wh: torch.Tensor  # [H_in, 4, Hs]
    b: torch.Tensor  # [4, Hs]
    packed: Optional[torch.Tensor]  # bf16 [T, NC, 64, 64] for the tensor-core kernel, else None


def pack_weights(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """wx [In, 4, Hs], wh [H_in, 4, Hs] (any dtype, Hs a multiple of 8) ->
    the tensor-core kernel's bf16 copy [T, NC, 64, 64], laid out as the
    kernel's shared-memory tiles so that each is one bulk copy: T = ceil(Hs /
    16) tiles of 16 units, NC = ceil(In / 64) + ceil(H_in / 64) chunks of 64
    along the depth [x | h].  Row n of a tile is gate column (n // 32
    granule, n // 8 % 4 gate, n % 8 unit) of units 16 t + 8 (n // 32) + n %
    8, its 64 depths K-major with the 128-byte swizzle: the 16-byte group j
    lands at j ^ (n % 8).  Zero past In, H_in and the last unit.  A column
    shard's tiles are the whole cell's tiles of its units."""
    In, _, H = wx.shape
    Hin = wh.shape[0]
    G, nxc, nhc = H // _GRANULE, -(-In // _CHUNK), -(-Hin // _CHUNK)
    T, NC = -(-G // 2), nxc + nhc
    w = torch.zeros((2 * T, 4, _GRANULE, NC * _CHUNK), dtype=torch.bfloat16, device=wx.device)
    w[:G, ..., :In] = wx.detach().view(In, 4, G, _GRANULE).permute(2, 1, 3, 0)
    w[:G, ..., nxc * _CHUNK:nxc * _CHUNK + Hin] = wh.detach().view(Hin, 4, G, _GRANULE).permute(2, 1, 3, 0)
    w = w.view(T, 64, NC, 8, 8).permute(0, 2, 1, 3, 4)  # [tile, chunk, row n, 16-byte group, 8 values]
    swz = torch.arange(8, device=wx.device)[None, :] ^ torch.arange(64, device=wx.device)[:, None] % 8
    return w[:, :, torch.arange(64, device=wx.device)[:, None], swz].reshape(T, NC, 64, 64).contiguous()


def _packable(wx: torch.Tensor, wh: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether the tensor-core kernel takes a feed of this dtype and widths."""
    In, _, H = wx.shape
    return (wx.device.type == "cuda" and dtype == torch.bfloat16 and In % 8 == 0 and H % 8 == 0
            and wh.shape[0] % 8 == 0)


def cast_weights(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> CellWeights:
    """The fp32 masters as a layer call in compute dtype ``dtype`` uses them,
    made once per layer call: rounded to ``dtype`` (as the JAX package's
    meshless cell casts them), kept as fp32 values for the plain version and
    the adjoint, and packed in bf16 for the tensor-core kernel where it runs.
    At fp32 this is the masters themselves: no copy."""
    with torch.no_grad():
        wx_r, wh_r, b_r = (t.detach().to(dtype).float() for t in (wx, wh, b))
        packed = pack_weights(wx, wh) if _packable(wx, wh, dtype) else None
    return CellWeights(wx_r, wh_r, b_r, packed)


def _check_shapes(x, h, c, wx, wh, b):
    if x.dim() != 2 or h.dim() != 2 or c.dim() != 2:
        raise ValueError(f"expected x [B,In], h [B,H_in], c [B,Hs]; got {tuple(x.shape)}, {tuple(h.shape)}, "
                         f"{tuple(c.shape)}")
    B, In = x.shape
    Hin, H = h.shape[1], c.shape[1]
    want = {"h": (B, Hin), "c": (B, H), "wx": (In, 4, H), "wh": (Hin, 4, H), "b": (4, H)}
    for name, t in (("h", h), ("c", c), ("wx", wx), ("wh", wh), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want[name]} for x {tuple(x.shape)}, "
                             f"h {tuple(h.shape)}, c {tuple(c.shape)}")
    if min(B, In, Hin, H) < 1:
        raise ValueError(f"empty dimension in B={B} In={In} H_in={Hin} Hs={H}")


def _check_kernel_inputs(x, ins, align16: bool):
    for name, t in ins:
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the kernel takes float32 or bfloat16, {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if align16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the tensor-core kernel")


def _launch(x, h, c, w: CellWeights):
    B, In = x.shape
    Hin, H = h.shape[1], c.shape[1]
    mma = w.packed is not None and x.dtype == torch.bfloat16
    if mma:
        ins = (("x", x), ("h", h), ("c", c), ("packed", w.packed), ("b", w.b))
        _check_kernel_inputs(x, ins, align16=True)
        if w.packed.dtype != torch.bfloat16 or tuple(w.packed.shape) != (
                -(-H // (2 * _GRANULE)), -(-In // _CHUNK) + -(-Hin // _CHUNK), 64, 64):
            raise ValueError(f"packed weights {w.packed.dtype} {tuple(w.packed.shape)} do not match x {tuple(x.shape)}")
    else:
        ins = (("x", x), ("h", h), ("c", c), ("wx", w.wx), ("wh", w.wh), ("b", w.b))
        _check_kernel_inputs(x, ins, align16=False)
    if -(-B // _ROWS_PER_BLOCK) > _MAX_GRID_Y or max(B * In, B * Hin, (In + Hin) * 4 * H) >= 2**31:
        raise ValueError(f"B={B} In={In} H_in={Hin} Hs={H} exceed the kernel's grid or int32 sizes")
    lib = _library()
    with torch.cuda.device(x.device):
        h_out, c_out = torch.empty((B, H), dtype=h.dtype, device=h.device), torch.empty_like(c)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mma:
            err = lib.lstm_cell_forward_mma(
                x.data_ptr(), h.data_ptr(), c.data_ptr(), w.packed.data_ptr(), w.b.data_ptr(),
                h_out.data_ptr(), c_out.data_ptr(), B, In, Hin, H,
                _DTYPE_CODES[h.dtype], _DTYPE_CODES[c.dtype], _DTYPE_CODES[w.b.dtype], stream,
            )
        else:
            err = lib.lstm_cell_forward(
                x.data_ptr(), h.data_ptr(), c.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(),
                h_out.data_ptr(), c_out.data_ptr(), B, In, Hin, H, *(_DTYPE_CODES[t.dtype] for _, t in ins), stream,
            )
    if err != 0:
        raise RuntimeError(f"lstm_cell launch failed: {lib.lstm_cell_error_string(err).decode()} ({err})")
    lstm_cell_fused.launches += 1
    if mma:
        lstm_cell_fused.mma_launches += 1
    else:
        lstm_cell_fused.fma_launches += 1
    key = ("mma" if mma else "fma", In, H)
    lstm_cell_fused.launches_by_shape[key] = lstm_cell_fused.launches_by_shape.get(key, 0) + 1
    return h_out, c_out


def lstm_cell_adjoint(x, h, c, wx, wh, b, dh_new, dc_new):
    """Analytic fp32 adjoint of one LSTM cell, gates recomputed from the
    saved inputs (the port of ``repro/kernels/lstm_cell/ops.py::
    lstm_cell_adjoint``).  (x [B, In], h [B, H_in] and c [B, Hs] previous
    state, dh_new / dc_new [B, Hs] cotangents of the new state, any dtype)
    -> fp32 (dx [B, In], dh [B, H_in], dc [B, Hs], dwx [In, 4, Hs], dwh
    [H_in, 4, Hs], db [4, Hs]).  On a column shard (Hs < H_in) dx and dh are
    this shard's terms of sums over the shards."""
    In, _, H = wx.shape
    Hin = wh.shape[0]
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
    wx2, wh2 = wx.float().reshape(In, 4 * H), wh.float().reshape(Hin, 4 * H)
    dx = torch.matmul(d_pre, wx2.t())
    dh = torch.matmul(d_pre, wh2.t())
    dc = dc_tot * f_s
    dwx = torch.matmul(x.float().t(), d_pre).view(In, 4, H)
    dwh = torch.matmul(h.float().t(), d_pre).view(Hin, 4, H)
    db = d_pre.sum(0).view(4, H)
    return dx, dh, dc, dwx, dwh, db


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b, w):
        ctx.save_for_backward(x, h, c)
        ctx.w = w
        ctx.dtypes = (x.dtype, h.dtype, c.dtype, wx.dtype, wh.dtype, b.dtype)
        if x.device.type == "cpu":
            return lstm_cell_ref(x, h, c, w.wx, w.wh, w.b)
        return _launch(x, h, c, w)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        x, h, c = ctx.saved_tensors
        w = ctx.w
        grads = lstm_cell_adjoint(x, h, c, w.wx, w.wh, w.b, dh_new, dc_new)
        return tuple(g.to(dt) if need else None
                     for g, dt, need in zip(grads, ctx.dtypes, ctx.needs_input_grad)) + (None,)


def lstm_cell_fused(x, h, c, wx, wh, b, *, weights: Optional[CellWeights] = None):
    """x [B, In], h [B, H_in], c [B, Hs], wx [In, 4, Hs], wh [H_in, 4, Hs],
    b [4, Hs], each fp32 or bf16 -> (h' [B, Hs] in h's dtype, c' in c's
    dtype); Hs = H_in is the whole cell, Hs < H_in a column shard of it.
    Differentiable: the backward is :func:`lstm_cell_adjoint`, grads in the
    arguments' dtypes.

    ``weights`` (from :func:`cast_weights` on ``wx, wh, b``, once per layer
    call) are what the cell computes with; ``wx, wh, b`` then only receive
    the grads.  Without it the cell computes with ``wx, wh, b`` as given,
    packing them for the tensor-core kernel on every call where it runs."""
    _check_shapes(x, h, c, wx, wh, b)
    devices = {t.device.type for t in (x, h, c, wx, wh, b)}
    if devices != {"cpu"} and devices != {"cuda"}:
        raise ValueError(f"lstm_cell_fused runs on CUDA (kernel) or CPU (plain version), not on {sorted(devices)}")
    if weights is None:
        packed = None
        if wx.dtype == wh.dtype == x.dtype and _packable(wx, wh, x.dtype):
            packed = pack_weights(wx, wh)
        weights = CellWeights(wx.detach(), wh.detach(), b.detach(), packed)
    else:
        _check_shapes(x, h, c, weights.wx, weights.wh, weights.b)
    return _LSTMCell.apply(x, h, c, wx, wh, b, weights)


lstm_cell_fused.launches = 0
lstm_cell_fused.mma_launches = 0
lstm_cell_fused.fma_launches = 0
lstm_cell_fused.launches_by_shape = {}


def reset_launches():
    """Set every launch count of :func:`lstm_cell_fused` to 0."""
    lstm_cell_fused.launches = lstm_cell_fused.mma_launches = lstm_cell_fused.fma_launches = 0
    lstm_cell_fused.launches_by_shape = {}
