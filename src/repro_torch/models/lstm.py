"""Stacked LSTM layers: the paper's encoder/decoder backbone.

The port of ``repro/models/lstm.py``.  ``stage_kernel`` picks what computes
each cell of :func:`run_stacked_lstm`:

* ``"torch"``: the plain cell with the JAX package's cast points: the gate
  GEMMs run and sum in the compute dtype, then upcast to fp32; the h/c
  carries stay fp32; h is returned in the compute dtype.  The weights are
  cast to the compute dtype once per layer call, not once per timestep;
  the gate products take the fp32 masters as their differentiable inputs
  beside that copy (:class:`_GateProducts`), so each step's weight grads
  reach the masters in fp32 and autograd sums the timesteps in fp32, as
  JAX's scan does.
* ``"cuda"``: the fused cell ``kernels/lstm_cell`` (its CUDA kernels on the
  card): x in the compute dtype, h and c fp32 carries, and the weights cast
  to the compute dtype once per layer call (``ops.cast_weights``), as the
  JAX package's meshless cell casts them; at fp32 that is the stored
  weights as they are, the JAX pipeline's stage-cell feed
  (``repro/core/pipeline.py:97-110``).  In bf16 the cell runs on the
  tensor-core kernel; the masters' grads are summed over the timesteps in
  fp32.  Its fp32 h is cast to the compute dtype before it enters the next
  layer.

Both go through :class:`StepCells`, which casts the weights once per call.
:func:`run_stacked_lstm` runs layer-major: layer l covers the whole sequence
before layer l+1.  The input-feeding decoder (``models/seq2seq.py``) runs
the same cells step-major: every layer of step t before step t+1.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import Initializer

STAGE_KERNELS = ("torch", "cuda")


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


def cast_cell(p: dict, dt: torch.dtype) -> dict:
    """The cell's weights in the compute dtype, as 2-D [in, 4H] matrices."""
    return {
        "wx": p["wx"].to(dt).reshape(p["wx"].shape[0], -1),
        "wh": p["wh"].to(dt).reshape(p["wh"].shape[0], -1),
        "b": p["b"].to(dt).reshape(-1),
    }


def _gates(x_t, h, pc: dict) -> torch.Tensor:
    return torch.matmul(x_t, pc["wx"]) + torch.matmul(h, pc["wh"]) + pc["b"]


class _GateProducts(torch.autograd.Function):
    """x_t wx + h wh + b on the compute-dtype copies ``pc``, whose weight
    grads go to the fp32 masters ``wx``, ``wh``, ``b`` in fp32: each step's
    term is computed in the compute dtype, as autograd would, and returned in
    fp32, so the sum over timesteps runs in fp32."""

    @staticmethod
    def forward(ctx, x_t, h, wx, wh, b, pc):
        ctx.save_for_backward(x_t, h, pc["wx"], pc["wh"])
        ctx.master_shapes = (wx.shape, wh.shape, b.shape)
        return _gates(x_t, h, pc)

    @staticmethod
    def backward(ctx, dg):
        x_t, h, wxc, whc = ctx.saved_tensors
        sx, sh, sb = ctx.master_shapes
        need = ctx.needs_input_grad
        dx = torch.matmul(dg, wxc.t()) if need[0] else None
        dh = torch.matmul(dg, whc.t()) if need[1] else None
        dwx = torch.matmul(x_t.t(), dg).float().reshape(sx) if need[2] else None
        dwh = torch.matmul(h.t(), dg).float().reshape(sh) if need[3] else None
        db = dg.sum(0).float().reshape(sb) if need[4] else None
        return dx, dh, dwx, dwh, db, None


def cell_step(pc: dict, x_t: torch.Tensor, state: LSTMCellState, masters: Optional[dict] = None
              ) -> Tuple[LSTMCellState, torch.Tensor]:
    """One plain cell step on weights that :func:`cast_cell` prepared.  With
    ``masters`` (the fp32 weights ``pc`` was cast from) the weight grads go
    to the masters in fp32 rather than to ``pc``."""
    dt = x_t.dtype
    B = x_t.shape[0]
    h = state.h.to(dt)
    if masters is None:
        gates = _gates(x_t, h, pc)
    else:
        gates = _GateProducts.apply(x_t, h, masters["wx"], masters["wh"], masters["b"], pc)
    gates = gates.float().view(B, 4, -1)
    i, f, g, o = gates.unbind(1)
    c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return LSTMCellState(h=h, c=c), h.to(dt)


def lstm_cell(p: dict, x_t: torch.Tensor, state: LSTMCellState) -> Tuple[LSTMCellState, torch.Tensor]:
    """x_t [B, in_dim] -> (new_state, h [B, H]): one plain cell step."""
    return cell_step(cast_cell(p, x_t.dtype), x_t, state)


def init_lstm_state(batch: int, hidden: int, device="cpu") -> LSTMCellState:
    z = torch.zeros((batch, hidden), dtype=torch.float32, device=device)
    return LSTMCellState(h=z, c=z.clone())


class StepCells:
    """A stacked LSTM's cells, called one cell and one timestep at a time, on
    ``stage_kernel``'s cell (see the module docstring); the weights are cast
    (and, for the tensor-core kernel, packed) once when the object is made, so
    once per layer or step call rather than once per cell.  Each call is
    differentiable and sends its weight grads to the fp32 masters ``layers``,
    so autograd sums them over the timesteps in fp32.  Layer-major
    (:func:`run_lstm_layer`) and step-major (the input-feeding decoder) loops
    both call it."""

    def __init__(self, layers: List[dict], dt: torch.dtype, stage_kernel: str):
        self.kind, self.dt, self.layers = stage_kernel, dt, layers
        with torch.no_grad():
            if stage_kernel == "cuda":
                from repro_torch.kernels.lstm_cell.ops import cast_weights

                self.w = [cast_weights(p["wx"], p["wh"], p["b"], dt) for p in layers]
            elif stage_kernel == "torch":
                self.pc = [cast_cell(p, dt) for p in layers]
            else:
                raise ValueError(f"stage_kernel must be one of {STAGE_KERNELS}, got {stage_kernel!r}")

    def init_state(self, l: int, batch: int, device) -> LSTMCellState:
        """Zero carries of layer ``l``: h as wide as its input from below, c
        as wide as its units (the same but for a column shard)."""
        wh = self.layers[l]["wh"]
        return LSTMCellState(h=torch.zeros((batch, wh.shape[0]), dtype=torch.float32, device=device),
                             c=torch.zeros((batch, wh.shape[2]), dtype=torch.float32, device=device))

    def __call__(self, l: int, x_t: torch.Tensor, state: LSTMCellState) -> Tuple[LSTMCellState, torch.Tensor]:
        """Layer ``l``'s cell on x_t [B, in] (contiguous on the kernel path)
        -> (fp32 state, h in the compute dtype)."""
        p = self.layers[l]
        if self.kind == "cuda":
            from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused

            h, c = lstm_cell_fused(x_t, state.h, state.c, p["wx"], p["wh"], p["b"], weights=self.w[l])
            return LSTMCellState(h=h, c=c), h.to(self.dt)
        return cell_step(self.pc[l], x_t, state, masters=p)


def run_lstm_layer(p: dict, xs: torch.Tensor, state: Optional[LSTMCellState] = None, *, stage_kernel: str = "torch"):
    """xs [B, S, in_dim] -> (hs [B, S, H] in xs's dtype, final_state): a
    loop over time where the JAX package scans."""
    B, S, _ = xs.shape
    cells = StepCells([p], xs.dtype, stage_kernel)
    if state is None:
        state = cells.init_state(0, B, xs.device)
    # the kernel takes each step's rows contiguous: [S, B, in]
    x_steps = xs.transpose(0, 1).contiguous() if stage_kernel == "cuda" else xs.transpose(0, 1)
    hs = []
    for t in range(S):
        state, h = cells(0, x_steps[t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def init_stacked_lstm(ini: Initializer, path: str, num_layers: int, in_dim: int, hidden: int) -> list:
    """Layer 0 consumes in_dim; layers 1.. consume hidden."""
    return [init_lstm_cell(ini, f"{path}.l{li}", in_dim if li == 0 else hidden, hidden) for li in range(num_layers)]


def dropout_keep(shape, p: float, generator: torch.Generator, device, rows: Optional[Tuple[int, int]] = None):
    """The keep mask of inverted dropout (each unit kept with probability
    1 - p), drawn from ``generator``.  With ``rows=(lo, full)`` the mask is
    drawn for ``full`` rows and rows ``lo:lo + shape[0]`` are returned: a
    rank holding some rows of a batch keeps the units that one process
    holding all of them would."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device) < 1.0 - p
    lo, full = rows
    keep = torch.rand((full, *shape[1:]), generator=generator, device=device) < 1.0 - p
    return keep[lo:lo + shape[0]]


def apply_keep(h: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Kept units scaled by 1 / (1 - p), the rest zero, in h's dtype."""
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype, device=h.device)).to(h.dtype)


def dropout(h: torch.Tensor, p: float, generator: torch.Generator, rows: Optional[Tuple[int, int]] = None
            ) -> torch.Tensor:
    """Inverted dropout: keep each unit with probability 1 - p and scale the
    kept ones by 1 / (1 - p); the keep mask comes from ``generator``
    (:func:`dropout_keep`)."""
    return apply_keep(h, dropout_keep(h.shape, p, generator, h.device, rows), p)


def run_stacked_lstm(params: List[dict], xs: torch.Tensor, states: Optional[List[LSTMCellState]] = None, *,
                     dropout_p: float = 0.0, generator: Optional[torch.Generator] = None,
                     stage_kernel: str = "torch", rows: Optional[Tuple[int, int]] = None):
    """Sequential (layer-major) stacked LSTM: layer l runs over the whole
    sequence before layer l+1 starts.  With ``dropout_p > 0`` and a
    ``generator``, inverted dropout is applied between layers (not after
    the last), as ``repro/models/lstm.py::run_stacked_lstm`` does; ``rows``
    (see :func:`dropout_keep`) places xs's rows in a larger batch."""
    B = xs.shape[0]
    hidden = params[0]["wh"].shape[0]
    new_states = []
    h = xs
    for li, p in enumerate(params):
        st = states[li] if states is not None else init_lstm_state(B, hidden, xs.device)
        h, fin = run_lstm_layer(p, h, st, stage_kernel=stage_kernel)
        new_states.append(fin)
        if dropout_p > 0.0 and generator is not None and li < len(params) - 1:
            h = dropout(h, dropout_p, generator, rows)
    return h, new_states
