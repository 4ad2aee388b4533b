"""Wavefront pipeline parallelism for stacked LSTMs over the ``model`` ranks
of a process grid: the paper's model parallelism (the port of
``repro/core/pipeline.py``), executed under an explicit
:class:`repro_torch.core.schedule.PipelineSchedule`.

The paper places each LSTM layer on its own GPU (Fig. 2/3); node (layer l,
time t) starts as soon as (l-1, t) and (l, t-1) finish, so the stack fills a
diagonal wavefront.  Here stage s is the process at ``model`` coordinate s;
it owns layers [s*Lp, (s+1)*Lp) (:func:`stage_params`: each layer keeps its
own tensors; torch needs no uniform scan shape, so layer 0 is not padded).
Over TT = k*S + NS - 1 clock ticks every stage computes its layers for
global token-step u = tau - s at tick tau, and hands its top hidden state to
stage s+1 by a point-to-point send: one ``batch_isend_irecv`` per tick, each
stage sending what it computed the tick before and receiving what it needs
now, so every rank posts its sends and receives in the order of the same
table and the ranks run in lockstep.  With one stage no send is made.

**Microbatch interleave**: with ``micro_batches=k`` the rank's rows split
into k slices that enter the wavefront back to back (microbatch m's step t
is token-step u = m*S + t); the recurrent state resets at every t == 0, so
the step runs in k*S + NS - 1 ticks, one fill/drain for the step.

**Schedule-driven backward**: the forward keeps only each stage's
*boundary inputs* (the hand-offs it received, one [B/k, H] row block per
token-step; stage 0 its embedded input).  The backward runs over the
schedule's groups (:attr:`PipelineSchedule.bwd_group_starts`): per group it
recomputes the member microbatches' forward from those boundaries, keeping
only that group's g*S token-steps of layer inputs and carries, then runs the
mirrored wavefront over the group, the hand-off gradient sent down the stage
chain each tick.  ``gpipe`` (and ``interleaved`` at one chunk) has one group
of all k microbatches; ``1f1b`` and ``zerobubble`` k groups of one, so the
backward holds S token-steps per stage whatever k is.  ``zerobubble``'s
table splits each backward unit into the input-grad B and the weight-grad
W; as in the JAX executor, the port computes W right after B (a table-legal
order: W has no dependents), so its gradients are 1f1b's.  Every order sums
the same terms; the weight grads are summed over the timesteps in fp32.

The stage cell is the meshless port's (``models/lstm.py``): ``"cuda"``, the
fused cell ``kernels/lstm_cell`` on weights cast once per call
(``ops.cast_weights``), whose per-cell backward is ``ops.lstm_cell_adjoint``;
``"torch"``, the plain cell, whose backward is autograd through
``models/lstm.py::_GateProducts`` (the weight grads in fp32).  The casts
between layers and the grads' dtypes are the meshless port's, so a pipelined
step equals the meshless step up to the order of its sums.

**Inter-layer dropout**: the JAX pipelined backbone drops it (``rng
unused``); the port's wavefront applies the meshless backbone's: each
layer's keep mask is drawn for the whole batch's [B, S, H] output in the
meshless port's generator order (encoder layers, then decoder layers) and
each rank keeps its own rows, so a pipelined step equals the meshless step
at any dropout (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import strategy as stg
from repro_torch.core.schedule import SCHEDULES, PipelineSchedule
from repro_torch.models import lstm

NOT_PORTED_INTERLEAVED = ("virtual_stages > 1: the interleaved ring executor is not ported "
                          "(ROADMAP queue 1 item 4)")


def stage_params(layer_params: List[dict], num_stages: int) -> List[List[dict]]:
    """[layer dicts] * L -> num_stages lists of Lp = L / num_stages layers,
    in order (the port's ``stack_pipeline_params``)."""
    L = len(layer_params)
    if L % num_stages:
        raise ValueError(f"{L} layers cannot split into {num_stages} stages")
    Lp = L // num_stages
    return [layer_params[s * Lp:(s + 1) * Lp] for s in range(num_stages)]


class _StageCells:
    """One stage's Lp cells on one kernel path, weights cast once per call."""

    def __init__(self, layers: List[dict], dt: torch.dtype, stage_kernel: str):
        self.kind, self.dt = stage_kernel, dt
        with torch.no_grad():
            if stage_kernel == "cuda":
                from repro_torch.kernels.lstm_cell.ops import cast_weights

                self.w = [cast_weights(p["wx"], p["wh"], p["b"], dt) for p in layers]
            elif stage_kernel == "torch":
                self.pc = [lstm.cast_cell(p, dt) for p in layers]
            else:
                raise ValueError(f"stage_kernel must be one of {lstm.STAGE_KERNELS}, got {stage_kernel!r}")
        self.layers = layers

    def forward(self, l: int, x, h, c):
        """(x [B, in] dt, h, c [B, H] fp32) -> (h, c) fp32, as the meshless cell."""
        if self.kind == "cuda":
            from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused

            p = self.layers[l]
            return lstm_cell_fused(x, h, c, p["wx"], p["wh"], p["b"], weights=self.w[l])
        st, _ = lstm.cell_step(self.pc[l], x, lstm.LSTMCellState(h, c))
        return st.h, st.c

    def backward(self, l: int, x, h, c, dh_state, dc, dh_out):
        """Grads of one cell from its inputs: ``dh_state`` (fp32) and ``dc``
        reach its h and c from the next timestep, ``dh_out`` (dt) its output
        cast to the compute dtype.  Returns (dx in dt, dh fp32, dc fp32,
        [dwx, dwh, db] fp32), the values the meshless step's autograd gives."""
        if self.kind == "cuda":
            from repro_torch.kernels.lstm_cell.ops import lstm_cell_adjoint

            w = self.w[l]
            dx, dh, dc_in, dwx, dwh, db = lstm_cell_adjoint(x, h, c, w.wx, w.wh, w.b, dh_state + dh_out.float(), dc)
            return dx.to(x.dtype), dh, dc_in, [dwx, dwh, db]
        p = self.layers[l]
        masters = {k: p[k].detach().requires_grad_() for k in ("wx", "wh", "b")}
        ins = [x.detach().requires_grad_(), h.detach().requires_grad_(), c.detach().requires_grad_()]
        with torch.enable_grad():
            st, h_dt = lstm.cell_step(self.pc[l], ins[0], lstm.LSTMCellState(ins[1], ins[2]), masters=masters)
            grads = torch.autograd.grad([st.h, st.c, h_dt], ins + list(masters.values()), [dh_state, dc, dh_out])
        return grads[0], grads[1], grads[2], list(grads[3:])


class _Wavefront:
    """One stage's part of one pipelined call: the forward wavefront and the
    schedule-driven backward, holding what the backward needs between the
    two."""

    def __init__(self, grid, sched: PipelineSchedule, layers: List[dict], keeps: List[Optional[torch.Tensor]],
                 dropout_p: float, stage_kernel: str, dt: torch.dtype, axis: str):
        self.grid, self.sched, self.axis = grid, sched, axis
        self.s, self.NS = grid.index(axis), sched.num_stages
        self.layers, self.keeps, self.p = layers, keeps, dropout_p
        self.cells = _StageCells(layers, dt, stage_kernel)
        self.dt = dt
        self.hidden = layers[0]["wh"].shape[0]

    # -- one tick of the stage --------------------------------------------

    def _sweep(self, first, h, c, m: int, t: int, inputs: Optional[list] = None):
        """The stage's Lp cells upward from the carries (h, c lists of [B, H]
        fp32), with the meshless step's inter-layer cast and dropout.  Returns
        (hs, cs, top); ``inputs`` collects each layer's input."""
        cur, hs, cs = first, [], []
        for l in range(len(self.layers)):
            if inputs is not None:
                inputs.append(cur)
            hl, cl = self.cells.forward(l, cur, h[l], c[l])
            hs.append(hl)
            cs.append(cl)
            cur = hl.to(self.dt)
            if self.keeps[l] is not None:
                cur = lstm.apply_keep(cur, self.keeps[l][m, t], self.p)
        return hs, cs, cur

    def _zeros(self, rows: int, device) -> list:
        return [torch.zeros((rows, self.hidden), dtype=torch.float32, device=device) for _ in self.layers]

    def _first(self, m: int, t: int):
        return self.x_steps[m, t] if self.s == 0 else self.lefts[m, t]

    # -- forward ----------------------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, in] (read on stage 0; its shape elsewhere) -> the top
        stage's [B, S, H] output in x's dtype (zeros on the other stages)."""
        s, NS, k = self.s, self.NS, self.sched.micro_batches
        B, S = x.shape[0], x.shape[1]
        Bm, H = B // k, self.hidden
        self.shape = (B, S, x.shape[2])
        if s == 0:  # [k, S, B/k, in]: each token-step's rows contiguous, as the cell kernel takes them
            self.x_steps = x.reshape(k, Bm, S, -1).permute(0, 2, 1, 3).contiguous()
        else:  # the boundary inputs: every hand-off this stage receives, kept for the backward
            self.lefts = x.new_empty((k, S, Bm, H))
        tops = x.new_empty((k, S, Bm, H)) if s == NS - 1 else None
        h = c = None
        sent = None  # what this stage computed last tick, for stage s+1
        for tau in range(self.sched.forward_ticks):
            u = tau - s
            valid = 0 <= u < k * S
            m, t = divmod(u, S)
            self.grid.exchange(send=sent, send_to=s + 1,
                               recv=self.lefts[m, t] if (s > 0 and valid) else None, recv_from=s - 1,
                               axis=self.axis).wait()
            sent = None
            if not valid:
                continue
            if t == 0:  # microbatches are independent row slices: the state resets
                h, c = self._zeros(Bm, x.device), self._zeros(Bm, x.device)
            h, c, top = self._sweep(self._first(m, t), h, c, m, t)
            if s == NS - 1:
                tops[m, t] = top
            else:
                sent = top
        if s != NS - 1:
            return x.new_zeros((B, S, H))
        return tops.permute(0, 2, 1, 3).reshape(B, S, H)

    # -- backward ---------------------------------------------------------

    def backward(self, dy: torch.Tensor):
        """dy [B, S, H] (read on the top stage) -> (dx [B, S, in] on stage 0
        else None, the stage's weight grads [wx, wh, b] per layer, fp32)."""
        s, NS, k = self.s, self.NS, self.sched.micro_batches
        B, S, In = self.shape
        Bm, H = B // k, self.hidden
        dev = dy.device
        dy_steps = dy.reshape(k, Bm, S, H).permute(0, 2, 1, 3) if s == NS - 1 else None
        dws = [[torch.zeros(p[n].shape, dtype=torch.float32, device=dev) for n in ("wx", "wh", "b")]
               for p in self.layers]
        dx_steps = torch.zeros((k, S, Bm, In), dtype=self.dt, device=dev) if s == 0 else None
        g = self.sched.bwd_group_size
        G = g * S
        dleft = torch.empty((Bm, H), dtype=self.dt, device=dev)
        for m0 in self.sched.bwd_group_starts:
            # phase A: recompute the group's forward from the boundary inputs,
            # keeping each token-step's layer inputs and entering carries
            stash = []
            with torch.no_grad():
                for j in range(G):
                    mi, t = divmod(j, S)
                    if t == 0:
                        h, c = self._zeros(Bm, dev), self._zeros(Bm, dev)
                    inputs = []
                    hs, cs, _ = self._sweep(self._first(m0 + mi, t), h, c, m0 + mi, t, inputs)
                    stash.append((inputs, h, c))
                    h, c = hs, cs
            # phase B: the mirrored wavefront over the group, the hand-off grad
            # sent DOWN the stage chain each tick
            sent = None
            for taub in range(G + NS - 1):
                v = taub - (NS - 1 - s)
                valid = 0 <= v < G
                self.grid.exchange(send=sent, send_to=s - 1,
                                   recv=dleft if (s < NS - 1 and valid) else None, recv_from=s + 1,
                                   axis=self.axis).wait()
                sent = None
                if not valid:
                    continue
                j = G - 1 - v
                mi, t = divmod(j, S)
                m = m0 + mi
                if t == S - 1:  # a microbatch's backward starts at its last step
                    dh, dc = self._zeros(Bm, dev), self._zeros(Bm, dev)
                g_out = dy_steps[m, t] if s == NS - 1 else dleft
                inputs, h_in, c_in = stash[j]
                for l in reversed(range(len(self.layers))):
                    if self.keeps[l] is not None:  # the dropout's backward, in the compute dtype
                        g_out = lstm.apply_keep(g_out, self.keeps[l][m, t], self.p)
                    g_out, dh[l], dc[l], dw = self.cells.backward(l, inputs[l], h_in[l], c_in[l], dh[l], dc[l],
                                                                  g_out)
                    for acc, d in zip(dws[l], dw):
                        acc += d
                if s == 0:
                    dx_steps[m, t] = g_out
                else:
                    sent = g_out
            del stash
        dx = dx_steps.permute(0, 2, 1, 3).reshape(B, S, In) if s == 0 else None
        return dx, [d for layer in dws for d in layer]


class _WavefrontFn(torch.autograd.Function):
    """The pipelined stacked LSTM as one autograd node per stage: collectives
    in its forward and in its backward."""

    @staticmethod
    def forward(ctx, run: _Wavefront, x, *weights):
        ctx.run = run
        return run.forward(x)

    @staticmethod
    def backward(ctx, dy):
        run, ctx.run = ctx.run, None
        dx, dws = run.backward(dy)
        return (None, dx, *dws)


def pipeline_lstm(grid, layer_params: List[dict], x: torch.Tensor, *, model_axis: str = "model",
                  micro_batches: int = 1, stage_kernel: str = "cuda", schedule: str = "gpipe",
                  virtual_stages: int = 1, dropout_p: float = 0.0, generator: Optional[torch.Generator] = None,
                  rows: Optional[tuple] = None) -> torch.Tensor:
    """Run a stacked LSTM over ``x`` [B, S, in] in wavefront order on this
    rank's stage.

    ``layer_params`` is the whole layer list (every rank holds it); the
    stage at ``model`` coordinate s computes and differentiates its own
    layers only.  ``micro_batches=k`` splits the rows into k slices
    interleaved through ONE wavefront.  ``schedule`` selects the
    :class:`PipelineSchedule` driving the backward (same gradients for every
    kind).  With ``dropout_p > 0`` and a ``generator`` the meshless
    backbone's inter-layer dropout applies, its masks drawn for ``rows=(lo,
    full)`` (x's rows in the whole batch, default all of it).  Returns the
    top layer's hidden states [B, S, H] in x's dtype on the top stage, zeros
    of that shape elsewhere."""
    if stage_kernel not in lstm.STAGE_KERNELS:
        raise ValueError(f"stage_kernel must be one of {lstm.STAGE_KERNELS}, got {stage_kernel!r}")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if virtual_stages > 1:
        raise NotImplementedError(NOT_PORTED_INTERLEAVED)
    NS, s = grid.size(model_axis), grid.index(model_axis)
    B, S, _ = x.shape
    k = micro_batches
    if B % k:
        raise ValueError(f"batch {B} not divisible by micro_batches = {k}")
    stages = stage_params(layer_params, NS)
    sched = PipelineSchedule(seq_len=S, num_stages=NS, micro_batches=k, kind=schedule)
    assert sched.forward_ticks == k * S + NS - 1  # one fill/drain per STEP
    # every rank draws every layer's mask, in the meshless generator order,
    # and keeps its own layers' masks at its rows, as [k, S, B/k, H]
    L, Lp, H = len(layer_params), len(stages[0]), layer_params[0]["wh"].shape[0]
    keeps = [None] * Lp
    if dropout_p > 0.0 and generator is not None:
        for gl in range(L - 1):
            keep = lstm.dropout_keep((B, S, H), dropout_p, generator, x.device, rows)
            if gl // Lp == s:
                keeps[gl % Lp] = keep.reshape(k, B // k, S, H).permute(0, 2, 1, 3).contiguous()
    run = _Wavefront(grid, sched, stages[s], keeps, dropout_p, stage_kernel, x.dtype, model_axis)
    weights = [p[n] for p in stages[s] for n in ("wx", "wh", "b")]
    return _WavefrontFn.apply(run, x, *weights)


def batch_shard_backbone(grid, batch_axes: tuple, dropout: float = 0.0, stage_kernel: str = "cuda"):
    """The backbone of a batch-sharded plan (DATA, or MODEL/HYBRID on a model
    axis of 1): each rank runs the meshless stacked LSTM on its rows, with
    the dropout masks of those rows in the whole batch."""
    i, n = stg.axes_index(grid, batch_axes), stg.axes_size(grid, batch_axes)

    def run(layer_params, xs, generator):
        B = xs.shape[0]
        return lstm.run_stacked_lstm(layer_params, xs, dropout_p=dropout, generator=generator,
                                     stage_kernel=stage_kernel, rows=(i * B, n * B))[0]

    return run


def pipeline_backbone(grid, model_axis: str = "model", micro_batches: int = 1, stage_kernel: str = "cuda",
                      schedule: str = "gpipe", virtual_stages: int = 1, dropout: float = 0.0):
    """Adapter for ``seq2seq.forward_no_input_feeding(backbone=...)``: runs
    the stacked-LSTM encoder/decoder on this rank's data shard through the
    wavefront pipeline (with the meshless backbone's dropout)."""
    axes = stg.data_axes(grid)
    d, D = stg.axes_index(grid, axes), stg.axes_size(grid, axes)

    def run(layer_params, xs, generator):
        B = xs.shape[0]
        return pipeline_lstm(
            grid, layer_params, xs, model_axis=model_axis, micro_batches=micro_batches,
            stage_kernel=stage_kernel, schedule=schedule, virtual_stages=virtual_stages,
            dropout_p=dropout, generator=generator, rows=(d * B, D * B),
        )

    return run
