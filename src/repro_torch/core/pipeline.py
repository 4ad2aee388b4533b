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

**Interleaved ring** (``virtual_stages=v > 1``, the port of JAX
``pipeline.py:420-663``): each stage's Lp layers split into v chunks of Lc =
Lp / v; chunk c on stage s is virtual stage vs = c*NS + s and holds global
layers [vs*Lc, (vs+1)*Lc), so the chain of VS = v*NS virtual stages walks the
stages as a ring.  Every tick each stage runs each of its chunks at
token-step u = tick - vs, and hands the v chunks' top states [v, B/k, H] to
stage s+1 (stage NS-1 to stage 0, which rolls them by one chunk: what stage
NS-1's chunk c made feeds its chunk c+1) in one ``batch_isend_irecv``; with
one stage the ring is local.  The backward mirrors it down the ring,
recomputing each chunk from its saved boundary inputs.

**Inter-layer dropout**: the JAX pipelined backbone drops it (``rng
unused``); the port's wavefront applies the meshless backbone's: each
layer's keep mask is drawn for the whole batch's [B, S, H] output in the
meshless port's generator order (encoder layers, then decoder layers) and
each rank keeps its own rows, so a pipelined step equals the meshless step
at any dropout (ROADMAP queue 3).

**Tensor-parallel backbone** (:func:`tensor_parallel_backbone`, JAX's MODEL
layout): every ``model`` rank runs every layer on its data shard's rows, on
the column shard of H/M units of each gate that it stores; per timestep its
cell (``kernels/lstm_cell`` at the shard's shape) makes [B, H/M] of h, and an
all-gather over ``model`` rebuilds h [B, H] for the next timestep and the
next layer.  The backward reduce-scatters dh over ``model``: each rank's dh
is its columns' term of the sum.  The input-feeding decoder runs the same
cells (:class:`ShardCells`) step-major, one cell of one timestep per
autograd node.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import strategy as stg
from repro_torch.core.schedule import SCHEDULES, PipelineSchedule
from repro_torch.models import lstm

def stage_params(layer_params: List[dict], num_stages: int) -> List[List[dict]]:
    """[layer dicts] * L -> num_stages lists of Lp = L / num_stages layers,
    in order (the port's ``stack_pipeline_params``)."""
    L = len(layer_params)
    if L % num_stages:
        raise ValueError(f"{L} layers cannot split into {num_stages} stages")
    Lp = L // num_stages
    return [layer_params[s * Lp:(s + 1) * Lp] for s in range(num_stages)]


def layer_stage(layer: int, num_layers: int, num_stages: int, virtual_stages: int = 1) -> int:
    """The stage that owns global layer ``layer``: its virtual stage's
    stage, virtual stage vs = c*NS + s holding layers [vs*Lc, (vs+1)*Lc)."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} layers cannot split into {num_stages} stages")
    Lp = num_layers // num_stages
    if Lp % virtual_stages:
        raise ValueError(f"{Lp} layers/device cannot split into {virtual_stages} virtual chunks")
    return (layer // (Lp // virtual_stages)) % num_stages


class _StageCells(lstm.StepCells):
    """One stage's Lp cells on one kernel path, weights cast once per call,
    called outside autograd: the forward of a cell, and its backward from its
    saved inputs."""

    def forward(self, l: int, x, h, c):
        """(x [B, in] dt, h, c [B, H] fp32) -> (h, c) fp32, as the meshless cell."""
        if self.kind == "cuda":
            from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused

            p = self.layers[l]
            return lstm_cell_fused(x, h, c, p["wx"], p["wh"], p["b"], weights=self.w[l])
        st, _ = lstm.cell_step(self.pc[l], x, lstm.LSTMCellState(h, c))
        return st.h, st.c

    def backward(self, l: int, x, h, c, dh_state, dc, dh_out=None):
        """Grads of one cell from its inputs: ``dh_state`` (fp32) and ``dc``
        reach its h and c from the next timestep, ``dh_out`` (dt; None: no
        such grad) its output cast to the compute dtype.  Returns (dx in dt,
        dh fp32, dc fp32, [dwx, dwh, db] fp32), the values the meshless
        step's autograd gives."""
        if self.kind == "cuda":
            from repro_torch.kernels.lstm_cell.ops import lstm_cell_adjoint

            w = self.w[l]
            dh_new = dh_state if dh_out is None else dh_state + dh_out.float()
            dx, dh, dc_in, dwx, dwh, db = lstm_cell_adjoint(x, h, c, w.wx, w.wh, w.b, dh_new, dc)
            return dx.to(x.dtype), dh, dc_in, [dwx, dwh, db]
        p = self.layers[l]
        masters = {k: p[k].detach().requires_grad_() for k in ("wx", "wh", "b")}
        ins = [x.detach().requires_grad_(), h.detach().requires_grad_(), c.detach().requires_grad_()]
        with torch.enable_grad():
            st, h_dt = lstm.cell_step(self.pc[l], ins[0], lstm.LSTMCellState(ins[1], ins[2]), masters=masters)
            outs, douts = [st.h, st.c], [dh_state, dc]
            if dh_out is not None:
                outs.append(h_dt)
                douts.append(dh_out)
            grads = torch.autograd.grad(outs, ins + list(masters.values()), douts)
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
    """One rank's part of a stacked LSTM that spans ranks (a pipeline stage,
    a ring stage's chunks, a tensor-parallel layer) as one autograd node:
    ``run`` holds the state, collectives in its forward and its backward."""

    @staticmethod
    def forward(ctx, run: _Wavefront, x, *weights):
        ctx.run = run
        return run.forward(x)

    @staticmethod
    def backward(ctx, dy):
        run, ctx.run = ctx.run, None
        dx, dws = run.backward(dy)
        return (None, dx, *dws)


class _Ring:
    """One stage's part of one interleaved call: its v chunks on the ring
    forward and the mirrored backward, holding what the backward needs."""

    def __init__(self, grid, sched: PipelineSchedule, chunks: List[List[dict]], keeps: List[list],
                 dropout_p: float, stage_kernel: str, dt: torch.dtype, axis: str):
        self.grid, self.sched, self.axis = grid, sched, axis
        self.s, self.NS, self.v = grid.index(axis), sched.num_stages, sched.chunks
        self.VS = self.v * self.NS
        # each chunk runs as a stage of the chain: its cells, masks and sweep
        self.chunks = [_Wavefront(grid, sched, layers, kp, dropout_p, stage_kernel, dt, axis)
                       for layers, kp in zip(chunks, keeps)]
        self.dt = dt
        self.hidden = chunks[0][0]["wh"].shape[0]

    def _vs(self, ci: int) -> int:
        return ci * self.NS + self.s

    def _ring(self, sent: torch.Tensor, recv: torch.Tensor, up: bool) -> torch.Tensor:
        """One hand-off of the chunks' [v, B/k, H] states around the ring:
        up (s -> s+1, NS-1 -> 0, which rolls them one chunk up) or down (the
        mirror).  Returns what this stage's chunks take in, chunk c at row c."""
        s, NS = self.s, self.NS
        got = sent
        if NS > 1:
            self.grid.exchange(send=sent, send_to=(s + 1) % NS if up else (s - 1) % NS,
                               recv=recv, recv_from=(s - 1) % NS if up else (s + 1) % NS, axis=self.axis).wait()
            got = recv
        if up and s == 0:
            return torch.roll(got, 1, dims=0)
        if not up and s == NS - 1:
            return torch.roll(got, -1, dims=0)
        return got.clone()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, in] (read on stage 0; its shape elsewhere) -> the last
        virtual stage's [B, S, H] output on stage NS-1 (zeros elsewhere)."""
        k, v = self.sched.micro_batches, self.v
        B, S, H = x.shape[0], x.shape[1], self.hidden
        Bm = B // k
        self.shape = (B, S, x.shape[2])
        self.x_steps = x.reshape(k, Bm, S, -1).permute(0, 2, 1, 3).contiguous() if self.s == 0 else None
        # the boundary inputs: every hand-off a chunk receives, kept for the backward
        self.lefts = [x.new_empty((k, S, Bm, H)) if self._vs(ci) > 0 else None for ci in range(v)]
        last = self.s == self.NS - 1
        tops = x.new_empty((k, S, Bm, H)) if last else None
        h, c = [None] * v, [None] * v
        sent, recv = x.new_zeros((v, Bm, H)), x.new_empty((v, Bm, H))
        for tau in range(self.sched.forward_ticks):
            left = self._ring(sent, recv, up=True) if tau > 0 else None
            for ci, ch in enumerate(self.chunks):
                vs = self._vs(ci)
                u = tau - vs
                if not 0 <= u < k * S:
                    continue
                m, t = divmod(u, S)
                if vs > 0:
                    self.lefts[ci][m, t] = left[ci]
                if t == 0:  # microbatches are independent row slices: the state resets
                    h[ci], c[ci] = ch._zeros(Bm, x.device), ch._zeros(Bm, x.device)
                first = self.x_steps[m, t] if vs == 0 else self.lefts[ci][m, t]
                h[ci], c[ci], top = ch._sweep(first, h[ci], c[ci], m, t)
                sent[ci] = top
                if vs == self.VS - 1:
                    tops[m, t] = top
        if not last:
            return x.new_zeros((B, S, H))
        return tops.permute(0, 2, 1, 3).reshape(B, S, H)

    def backward(self, dy: torch.Tensor):
        """dy [B, S, H] (read on stage NS-1) -> (dx [B, S, in] on stage 0
        else None, the chunks' weight grads [wx, wh, b] per layer, fp32)."""
        k, v, NS, VS = self.sched.micro_batches, self.v, self.NS, self.VS
        B, S, In = self.shape
        Bm, H = B // k, self.hidden
        dev = dy.device
        dy_steps = dy.reshape(k, Bm, S, H).permute(0, 2, 1, 3) if self.s == NS - 1 else None
        dws = [[[torch.zeros(p[n].shape, dtype=torch.float32, device=dev) for n in ("wx", "wh", "b")]
                for p in ch.layers] for ch in self.chunks]
        dx_steps = torch.zeros((k, S, Bm, In), dtype=self.dt, device=dev) if self.s == 0 else None
        G = self.sched.bwd_group_size * S
        for m0 in self.sched.bwd_group_starts:
            # phase A: each chunk recomputes the group's forward from its saved boundary inputs
            stash = [[] for _ in range(v)]
            with torch.no_grad():
                for ci, ch in enumerate(self.chunks):
                    for j in range(G):
                        mi, t = divmod(j, S)
                        if t == 0:
                            h, c = ch._zeros(Bm, dev), ch._zeros(Bm, dev)
                        inputs = []
                        first = self.x_steps[m0 + mi, t] if self._vs(ci) == 0 else self.lefts[ci][m0 + mi, t]
                        hs, cs, _ = ch._sweep(first, h, c, m0 + mi, t, inputs)
                        stash[ci].append((inputs, h, c))
                        h, c = hs, cs
            # phase B: the mirrored VS-deep wavefront, the hand-off grads sent down the ring
            dh, dc = [None] * v, [None] * v
            sent = torch.zeros((v, Bm, H), dtype=self.dt, device=dev)
            recv = torch.empty((v, Bm, H), dtype=self.dt, device=dev)
            for taub in range(G + VS - 1):
                dleft = self._ring(sent, recv, up=False) if taub > 0 else None
                for ci, ch in enumerate(self.chunks):
                    vs = self._vs(ci)
                    vb = taub - (VS - 1 - vs)
                    if not 0 <= vb < G:
                        continue
                    j = G - 1 - vb
                    mi, t = divmod(j, S)
                    m = m0 + mi
                    if t == S - 1:  # a microbatch's backward starts at its last step
                        dh[ci], dc[ci] = ch._zeros(Bm, dev), ch._zeros(Bm, dev)
                    g_out = dy_steps[m, t] if vs == VS - 1 else dleft[ci]
                    inputs, h_in, c_in = stash[ci][j]
                    for l in reversed(range(len(ch.layers))):
                        if ch.keeps[l] is not None:  # the dropout's backward, in the compute dtype
                            g_out = lstm.apply_keep(g_out, ch.keeps[l][m, t], ch.p)
                        g_out, dh[ci][l], dc[ci][l], dw = ch.cells.backward(l, inputs[l], h_in[l], c_in[l],
                                                                            dh[ci][l], dc[ci][l], g_out)
                        for acc, d in zip(dws[ci][l], dw):
                            acc += d
                    if vs == 0:
                        dx_steps[m, t] = g_out
                    else:
                        sent[ci] = g_out
            del stash
        dx = dx_steps.permute(0, 2, 1, 3).reshape(B, S, In) if self.s == 0 else None
        return dx, [d for chunk in dws for layer in chunk for d in layer]


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
    if virtual_stages > 1 and schedule != "interleaved":
        raise ValueError(f"virtual_stages={virtual_stages} requires schedule='interleaved', got {schedule!r}")
    NS, s = grid.size(model_axis), grid.index(model_axis)
    B, S, _ = x.shape
    k = micro_batches
    if B % k:
        raise ValueError(f"batch {B} not divisible by micro_batches = {k}")
    stages = stage_params(layer_params, NS)
    v = virtual_stages
    L, Lp, H = len(layer_params), len(stages[0]), layer_params[0]["wh"].shape[0]
    if Lp % v:
        raise ValueError(f"{Lp} layers/device cannot split into {v} virtual chunks")
    sched = PipelineSchedule(seq_len=S, num_stages=NS, micro_batches=k, kind=schedule, chunks=v)
    assert sched.forward_ticks == k * S + v * NS - 1  # one fill/drain per STEP
    # every rank draws every layer's mask, in the meshless generator order,
    # and keeps its own layers' masks at its rows, as [k, S, B/k, H]
    keeps = {}
    if dropout_p > 0.0 and generator is not None:
        for gl in range(L - 1):
            keep = lstm.dropout_keep((B, S, H), dropout_p, generator, x.device, rows)
            if layer_stage(gl, L, NS, v) == s:
                keeps[gl] = keep.reshape(k, B // k, S, H).permute(0, 2, 1, 3).contiguous()
    if v == 1:
        run = _Wavefront(grid, sched, stages[s], [keeps.get(s * Lp + l) for l in range(Lp)], dropout_p,
                         stage_kernel, x.dtype, model_axis)
        weights = [p[n] for p in stages[s] for n in ("wx", "wh", "b")]
        return _WavefrontFn.apply(run, x, *weights)
    # chunk c of stage s: virtual stage c*NS + s, global layers [vs*Lc, (vs+1)*Lc)
    Lc = Lp // v
    firsts = [(c * NS + s) * Lc for c in range(v)]
    chunks = [layer_params[f:f + Lc] for f in firsts]
    run = _Ring(grid, sched, chunks, [[keeps.get(f + l) for l in range(Lc)] for f in firsts], dropout_p,
                stage_kernel, x.dtype, model_axis)
    weights = [p[n] for chunk in chunks for p in chunk for n in ("wx", "wh", "b")]
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


class ShardCells(_StageCells):
    """A stacked LSTM's layers on this rank's column shards of their units (h
    [B, H] whole, c and the weights of this rank's H/M units).  A cell's
    forward is the column-shard cell, then one all-gather of h over
    ``model``; its backward is one reduce-scatter of dh (this rank's term of
    the sum), then the cell's adjoint.  The tensor-parallel backbone runs
    them layer-major (:class:`_TensorParallelLayer`); the input-feeding
    decoder calls them one cell and one timestep at a time, each call one
    :class:`_ShardCellFn` whose weight grads go to the shard's fp32 masters
    (autograd sums them over the steps)."""

    def __init__(self, grid, axis: str, layers: List[dict], dt: torch.dtype, stage_kernel: str):
        super().__init__(layers, dt, stage_kernel)  # cast (and packed) once per call
        self.grid, self.axis = grid, axis

    def shard_forward(self, l: int, x, h, c):
        """(x [B, In] dt, h [B, H] whole, c [B, H/M], fp32) -> (h [B, H] whole, c [B, H/M]) fp32."""
        h_shard, c = self.forward(l, x, h, c)
        return self.grid.all_gather(h_shard, self.axis, dim=1), c

    def shard_backward(self, l: int, x, h, c, dh, dc):
        """dh [B, H] fp32 (this rank's term of the sum over ``model``), dc [B,
        H/M] -> (dx in dt, dh [B, H], dc, [dwx, dwh, db]): dx and dh this
        rank's terms, the weight grads the shard's, fp32."""
        return self.backward(l, x, h, c, self.grid.reduce_scatter(dh, self.axis, dim=1), dc)

    def __call__(self, l: int, x_t: torch.Tensor, state: lstm.LSTMCellState):
        p = self.layers[l]
        h, c = _ShardCellFn.apply(self, l, x_t, state.h, state.c, p["wx"], p["wh"], p["b"])
        return lstm.LSTMCellState(h=h, c=c), h.to(self.dt)


class _ShardCellFn(torch.autograd.Function):
    """One cell of one timestep of :class:`ShardCells`, as an autograd node."""

    @staticmethod
    def forward(ctx, cells, l: int, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c)
        ctx.cells, ctx.l = cells, l
        return cells.shard_forward(l, x, h, c)

    @staticmethod
    def backward(ctx, dh, dc):
        x, h, c = ctx.saved_tensors
        cells, ctx.cells = ctx.cells, None
        dx, dh_in, dc_in, dw = cells.shard_backward(ctx.l, x, h, c, dh.float(), dc.float())
        return (None, None, dx, dh_in, dc_in, *dw)


class _TensorParallelLayer:
    """One LSTM layer of :class:`ShardCells` over the timesteps, as one
    autograd node: the forward of every timestep, and the backward of every
    timestep from the saved states."""

    def __init__(self, grid, axis: str, layer: dict, dt: torch.dtype, stage_kernel: str):
        self.dt = dt
        self.cells = ShardCells(grid, axis, [layer], dt, stage_kernel)  # cast (and packed) once per layer call
        self.hidden, self.units = layer["wh"].shape[0], layer["wh"].shape[2]
        self.shapes = [layer[n].shape for n in ("wx", "wh", "b")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, In] (the same on every ``model`` rank) -> h [B, S, H] in x's dtype."""
        B, S, _ = x.shape
        self.x_steps = x.transpose(0, 1).contiguous()  # [S, B, In]: each step's rows contiguous, as the cell takes
        h = torch.zeros((B, self.hidden), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, self.units), dtype=torch.float32, device=x.device)
        self.states = []
        out = x.new_empty((B, S, self.hidden))  # contiguous, as the meshless stack and the head kernel take it
        for t in range(S):
            self.states.append((h, c))
            h, c = self.cells.shard_forward(0, self.x_steps[t], h, c)
            out[:, t] = h.to(self.dt)
        return out

    def backward(self, dy: torch.Tensor):
        """dy [B, S, H] (this rank's term of the sum over ``model``) -> (dx
        [B, S, In], this rank's term; [dwx, dwh, db] of the shard, fp32
        sums over the timesteps)."""
        S, B, In = self.x_steps.shape
        dev = dy.device
        dws = [torch.zeros(sh, dtype=torch.float32, device=dev) for sh in self.shapes]
        dx = torch.empty((S, B, In), dtype=self.dt, device=dev)
        dh = torch.zeros((B, self.hidden), dtype=torch.float32, device=dev)
        dc = torch.zeros((B, self.units), dtype=torch.float32, device=dev)
        for t in reversed(range(S)):
            h, c = self.states[t]
            dx[t], dh, dc, dw = self.cells.shard_backward(0, self.x_steps[t], h, c, dh + dy[:, t].float(), dc)
            for acc, d in zip(dws, dw):
                acc += d
        self.states = None
        return dx.transpose(0, 1), dws


def tensor_parallel_backbone(grid, model_axis: str = "model", dropout: float = 0.0, stage_kernel: str = "cuda"):
    """The backbone of the tensor-parallel layouts (MODEL and HYBRID without
    the pipeline, HYBRID_OPT): each rank runs every layer on its data shard's
    rows and its column shard of the layer's units (``layer_params`` hold
    [In, 4, H/M] blocks, gathered over ``data`` already where FSDP shards
    them), with the meshless backbone's dropout masks of its rows: the same
    on every ``model`` rank, so they drop the same units."""
    axes = stg.data_axes(grid)

    def run(layer_params, xs, generator):
        B = xs.shape[0]
        d, D = stg.axes_index(grid, axes), stg.axes_size(grid, axes)
        h = xs
        for li, p in enumerate(layer_params):
            layer = _TensorParallelLayer(grid, model_axis, p, xs.dtype, stage_kernel)
            h = _WavefrontFn.apply(layer, h, p["wx"], p["wh"], p["b"])
            if dropout > 0.0 and generator is not None and li < len(layer_params) - 1:
                h = lstm.dropout(h, dropout, generator, (d * B, D * B))
        return h

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
