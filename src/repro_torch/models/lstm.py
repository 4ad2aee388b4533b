"""Stacked LSTM layers: the paper's encoder/decoder backbone.

The port of ``repro/models/lstm.py`` with its cast points kept: the gate
GEMMs run and sum in the compute dtype, then upcast to fp32; the h/c
carries stay fp32; h is returned in the compute dtype.  The gate GEMMs are
plain ``torch.matmul`` (the JAX package leaves them to XLA on this path).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import Initializer


class LSTMCellState(NamedTuple):
    h: torch.Tensor  # [B, H] fp32
    c: torch.Tensor  # [B, H] fp32


def init_lstm_cell(ini: Initializer, path: str, in_dim: int, hidden: int) -> dict:
    """Gate weights in the explicit [in, 4, H] layout (i/f/g/o on the ``4``
    axis)."""
    return {
        "wx": ini.normal(path + ".wx", (in_dim, 4, hidden), scale=in_dim**-0.5),
        "wh": ini.normal(path + ".wh", (hidden, 4, hidden), scale=hidden**-0.5),
        "b": ini.zeros(path + ".b", (4, hidden)),
    }


def lstm_cell(p: dict, x_t: torch.Tensor, state: LSTMCellState) -> Tuple[LSTMCellState, torch.Tensor]:
    """x_t [B, in_dim] -> (new_state, h [B, H])."""
    dt = x_t.dtype
    wx, wh = p["wx"].to(dt), p["wh"].to(dt)
    B = x_t.shape[0]
    gates = (
        torch.matmul(x_t, wx.reshape(wx.shape[0], -1))
        + torch.matmul(state.h.to(dt), wh.reshape(wh.shape[0], -1))
        + p["b"].to(dt).reshape(-1)
    ).float().view(B, 4, -1)
    i, f, g, o = gates.unbind(1)
    c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return LSTMCellState(h=h, c=c), h.to(dt)


def init_lstm_state(batch: int, hidden: int, device="cpu") -> LSTMCellState:
    z = torch.zeros((batch, hidden), dtype=torch.float32, device=device)
    return LSTMCellState(h=z, c=z.clone())


def run_lstm_layer(p: dict, xs: torch.Tensor, state: Optional[LSTMCellState] = None):
    """xs [B, S, in_dim] -> (hs [B, S, H], final_state): a loop over time
    where the JAX package scans."""
    B, S, _ = xs.shape
    if state is None:
        state = init_lstm_state(B, p["wh"].shape[0], xs.device)
    hs = []
    for t in range(S):
        state, h = lstm_cell(p, xs[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def init_stacked_lstm(ini: Initializer, path: str, num_layers: int, in_dim: int, hidden: int) -> list:
    """Layer 0 consumes in_dim; layers 1.. consume hidden."""
    return [init_lstm_cell(ini, f"{path}.l{li}", in_dim if li == 0 else hidden, hidden) for li in range(num_layers)]


def run_stacked_lstm(params: List[dict], xs: torch.Tensor, states: Optional[List[LSTMCellState]] = None):
    """Sequential (layer-major) stacked LSTM: layer l runs over the whole
    sequence before layer l+1 starts.  No dropout: the serving path runs
    with none (the training slice adds it)."""
    B = xs.shape[0]
    hidden = params[0]["wh"].shape[0]
    new_states = []
    h = xs
    for li, p in enumerate(params):
        st = states[li] if states is not None else init_lstm_state(B, hidden, xs.device)
        h, fin = run_lstm_layer(p, h, st)
        new_states.append(fin)
    return h, new_states
