"""Plain PyTorch version of the fused LSTM cell.

fp32 math from any input dtype, like ``repro/kernels/lstm_cell/ref.py``; the
outputs are in h's and c's dtypes.  The CPU path of
``ops.lstm_cell_fused`` runs this, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch


def lstm_gates(x, h, wx, wh, b):
    """Pre-activation gates [B, 4, Hs] in fp32: x Wx + h Wh + b (h [B, H_in]
    whole, the weights of Hs units)."""
    In, _, H = wx.shape
    gates = torch.matmul(x.float(), wx.float().reshape(In, 4 * H))
    gates = gates + torch.matmul(h.float(), wh.float().reshape(wh.shape[0], 4 * H))
    return gates.view(-1, 4, H) + b.float()


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x [B, In], h [B, H_in], c [B, Hs], wx [In, 4, Hs], wh [H_in, 4, Hs],
    b [4, Hs] -> (h', c') [B, Hs]: the whole cell at Hs = H_in, else the
    column shard of Hs units that these weights hold."""
    i, f, g, o = lstm_gates(x, h, wx, wh, b).unbind(1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)
