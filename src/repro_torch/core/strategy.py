"""Parallelization strategies on a process grid (the port of
``repro/core/strategy.py``).

The paper's three training configurations, and the JAX package's fourth:

========== =============================================================
SINGLE     every rank runs the whole batch (one card, or replicas)
DATA       paper §2.1: every parameter replicated, the batch sharded over
           ALL ranks, every grad all-reduced over the grid
MODEL      paper §2.2: the stacked LSTMs split layer-wise over the
           ``model`` ranks (the wavefront pipeline), the batch over
           ``data``; the head runs on the top stage
HYBRID     the paper's contribution (§3.2): the backbone as MODEL, then the
           top stage's hidden states are scattered over ALL ranks
           (``phase_boundary``) and the attention-softmax head, replicated,
           runs data-parallel on every rank's rows
HYBRID_OPT beyond the paper: the backbone as MODEL without the pipeline,
           the head vocab-sharded over ``model`` and the large weight
           dims FSDP-sharded over ``data`` (ZeRO-3 style)
========== =============================================================

MODEL and HYBRID without ``use_pipeline`` on a ``model`` axis above 1, and
HYBRID_OPT on any grid, are the JAX package's tensor-parallel layouts: each
parameter leaf is placed by the JAX rule (:func:`resolve_specs`, the port's
copy of ``repro/core/strategy.py:47-198``), a rank stores only its block of
each sharded dim (:func:`shard_leaf`), and :class:`Sharding` gathers what a
computation needs whole.

Where the JAX package maps logical axes to mesh axes and lets GSPMD insert
the collectives, the port's ranks hold their own rows and blocks and call the
collectives themselves, each as an autograd ``Function`` with a collective in
each direction: the phase boundary's scatter (:func:`phase_boundary_fn`), a
gather of a sharded weight (its grad reduce-scattered), the vocab-parallel
embedding lookup and cross-entropy.

The gradients of activations that every ``model`` rank holds whole (the
tensor-parallel backbone's h, the embeddings, a replicated head's inputs)
are kept as each rank's term of a sum over ``model``: a column shard of the
cell adds its columns' share, a rank's head rows their own.  So a leaf's
grad is whole once it is summed over the grid axes that do not shard it
(:func:`grad_axes`).

The LMs' tensor-parallel blocks keep the other convention (Megatron's):
the residual stream's grad is whole on every ``model`` rank.  A block is
entered through :func:`copy_to_model` (its grad all-reduced over ``model``
in the backward) and left through :func:`sum_from_model` (the partial
outputs summed in fp32 in the forward), the expert-parallel MoE takes its
rows with :func:`split_rows` and gives them back with :func:`gather_rows`,
and the head's rows under HYBRID are :func:`lm_phase_boundary`'s.  A leaf
that ``model`` does not shard then has its grad whole on every ``model``
rank when it acts on such an activation (the norms), and the rank's term
when it reads the rank's own heads, tokens or rows
(``ExecutionPlan.leaf_roles``).
"""
from __future__ import annotations

import enum
from typing import Optional

import torch

from repro_torch.models.common import tree_map


class Strategy(str, enum.Enum):
    SINGLE = "single"
    DATA = "data"
    MODEL = "model"
    HYBRID = "hybrid"
    HYBRID_OPT = "hybrid_opt"


HEAD_KEYS = ("head", "lm_head", "final_norm")  # the attention-softmax part

# Logical names that may be sharded over the `model` axis, in priority order:
# if several dims of one parameter are eligible, the first divisible one
# wins and the rest stay replicated (one grid axis shards at most one dim).
MODEL_AXIS_PRIORITY = (
    "expert",
    "vocab",
    "kv_heads",
    "q_groups",
    "ff",
    "qdim",
    "kvdim",
    "hdv",
    "heads",
)
# Dims eligible for FSDP over `data` in HYBRID_OPT (weight-matrix dims).
FSDP_ELIGIBLE = ("embed", "ff", "vocab", "qdim", "kvdim")
FSDP_FLOOR = 1024  # a dim shorter than this is never FSDP-sharded


def data_axes(grid) -> tuple:
    return tuple(a for a in grid.axis_names if a in ("pod", "data"))


def all_axes(grid) -> tuple:
    return tuple(grid.axis_names)


def batch_axes(strategy: Strategy, grid) -> tuple:
    """The grid axes the batch dimension of the inputs shards over (the
    port's ``batch_spec``)."""
    if grid is None or strategy == Strategy.SINGLE:
        return ()
    if strategy == Strategy.DATA:
        return all_axes(grid)
    return data_axes(grid)


def axes_size(grid, axes: tuple) -> int:
    """Product of the sizes of ``axes``."""
    n = 1
    for a in axes:
        n *= grid.size(a)
    return n


def axes_index(grid, axes: tuple) -> int:
    """This rank's block among ``axes_size`` equal row blocks split over
    ``axes`` (all axes: data-major, as ``P(("data", "model"))`` orders them;
    the data axes: its data coordinate)."""
    if not axes:
        return 0
    return grid.index("all") if tuple(axes) == all_axes(grid) else grid.index("data")


def batch_shard_size(strategy: Strategy, grid) -> int:
    """Product of the grid axis sizes the batch shards over."""
    return 1 if grid is None else axes_size(grid, batch_axes(strategy, grid))


def batch_shard_index(strategy: Strategy, grid) -> int:
    """This rank's batch shard: its block of ``batch_shard_size`` equal row blocks."""
    return 0 if grid is None else axes_index(grid, batch_axes(strategy, grid))


def model_shard_size(strategy: Strategy, grid) -> int:
    """Size of the ``model`` axis as the strategy uses it: 1 unless the
    strategy splits the backbone over it."""
    if grid is None or strategy in (Strategy.SINGLE, Strategy.DATA):
        return 1
    return grid.size("model")


# ---------------------------------------------------------------------------
# parameter placement (the JAX rule, ``repro/core/strategy.py:124-198``)
# ---------------------------------------------------------------------------


def _resolve_leaf(spec: Optional[tuple], shape: tuple, grid, shard_model: bool, fsdp: bool) -> tuple:
    """One leaf's placement: per dim, the grid axis that shards it or None."""
    assigned = [None] * len(shape)
    if spec is None:
        spec = (None,) * len(shape)
    if shard_model:
        done = False
        for name in MODEL_AXIS_PRIORITY:
            if done:
                break
            for i, s in enumerate(spec):
                if s == name and assigned[i] is None and not done and shape[i] % grid.size("model") == 0:
                    assigned[i] = "model"
                    done = True
    if fsdp:
        dsz = grid.size("data")
        cands = [(shape[i], i) for i, s in enumerate(spec)
                 if s in FSDP_ELIGIBLE and assigned[i] is None and shape[i] % dsz == 0 and shape[i] >= FSDP_FLOOR]
        if cands:
            assigned[max(cands)[1]] = "data"
    return tuple(assigned)


def map_shapes(fn, tree, *others):
    """``fn(leaf, *other leaves)`` over a tree of dicts and lists whose
    leaves are tuples (shapes, logical specs, placements), which
    ``models.common.tree_map`` would walk into; ``others`` share its
    structure."""
    if isinstance(tree, dict):
        return {k: map_shapes(fn, tree[k], *(o[k] for o in others)) for k in tree}
    if isinstance(tree, list):
        return [map_shapes(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree)]
    return fn(tree, *others)


def resolve_specs(specs, shapes, grid, strategy: Strategy, *, is_head: bool = False):
    """A logical spec tree (leaves: tuples of logical dim names) and the
    matching tree of whole shapes -> the placement tree (leaves: tuples of
    a grid axis or None per dim), as the JAX rule resolves it."""
    strategy = Strategy(strategy)
    if grid is None or strategy in (Strategy.SINGLE, Strategy.DATA):
        return map_shapes(lambda shape, spec: (None,) * len(shape), shapes, specs)
    shard_model = not (strategy == Strategy.HYBRID and is_head)  # HYBRID: the head replicated (the paper)
    fsdp = strategy == Strategy.HYBRID_OPT
    return map_shapes(lambda shape, spec: _resolve_leaf(spec, tuple(shape), grid, shard_model, fsdp), shapes, specs)


def param_placement(specs: dict, shapes: dict, grid, strategy: Strategy) -> dict:
    """The whole tree's placement; top-level keys in HEAD_KEYS get the head
    treatment (``repro/core/strategy.py::param_shardings``)."""
    return {key: resolve_specs(specs[key], shapes[key], grid, strategy, is_head=key in HEAD_KEYS) for key in specs}


def leaf_axes(placed: tuple) -> tuple:
    """The grid axes that shard a leaf placed as ``placed``, in AXES order."""
    return tuple(a for a in ("data", "model") if a in placed)


def axis_name(axes: tuple) -> Optional[str]:
    """The grid axis naming a set of axes: None, "data", "model" or "all"."""
    axes = set(axes)
    if not axes:
        return None
    if axes == {"data", "model"}:
        return "all"
    return axes.pop()


def grad_axes(placed: tuple, grid) -> tuple:
    """The axes of size > 1 a leaf's grad is summed over: those that do not
    shard it (a sharded dim's grad arrives reduce-scattered or whole)."""
    return tuple(a for a in ("data", "model") if a not in placed and grid.size(a) > 1)


def shard_leaf(t: torch.Tensor, placed: tuple, grid) -> torch.Tensor:
    """This rank's block of a whole leaf: along each sharded dim, block
    ``index(axis)`` of ``size(axis)`` equal contiguous blocks (the layout of
    a JAX ``PartitionSpec``); a copy, so the whole leaf can be freed."""
    for dim, axis in enumerate(placed):
        if axis is not None:
            n = grid.size(axis)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {n} blocks over {axis!r}")
            t = t.chunk(n, dim=dim)[grid.index(axis)]
    return t.detach().clone().contiguous()


def gather_leaf(t: torch.Tensor, placed: tuple, grid) -> torch.Tensor:
    """The inverse of :func:`shard_leaf`, without autograd: the leaf whole
    along every sharded dim (every rank calls it)."""
    for dim, axis in enumerate(placed):
        if axis is not None:
            t = grid.all_gather(t, axis, dim=dim)
    return t


def shard_params(params, placement: dict, grid):
    """This rank's blocks of the whole tree ``params`` under ``placement``
    (``ExecutionPlan.placement``): each sharded leaf a contiguous block per
    sharded dim, in rank order, as a JAX ``PartitionSpec`` lays it out;
    every other leaf as it is."""
    return tree_map(lambda t, p: shard_leaf(t, p, grid) if any(p) else t, params, placement)


class _GatherFn(torch.autograd.Function):
    """Forward: the blocks of ``axis`` gathered whole along ``dim``.
    Backward: the grad summed over ``axis`` and this rank's block kept (a
    reduce-scatter): the terms of every rank that used the whole weight."""

    @staticmethod
    def forward(ctx, t, grid, axis, dim):
        ctx.grid, ctx.axis, ctx.dim = grid, axis, dim
        return grid.all_gather(t, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.reduce_scatter(g.contiguous(), ctx.axis, dim=ctx.dim), None, None, None


class _VocabEmbedFn(torch.autograd.Function):
    """The embedding lookup on a vocab-sharded table: each rank looks up the
    tokens its rows of the table hold (zeros elsewhere) and the ranks' rows
    are summed over ``axis``.  Backward: the output's grad summed over
    ``axis`` when it holds each rank's term (``reduce_grad``; whole on every
    rank otherwise), then scattered into this rank's rows of the table."""

    @staticmethod
    def forward(ctx, table, tokens, grid, axis, dt, reduce_grad=True):
        V = table.shape[0]
        lo = grid.index(axis) * V
        mine = (tokens >= lo) & (tokens < lo + V)
        idx = torch.where(mine, tokens - lo, torch.zeros_like(tokens)).long()
        out = torch.where(mine[..., None], table[idx].float(), torch.zeros((), device=table.device))
        grid.all_reduce(out, axis).wait()
        ctx.save_for_backward(idx, mine)
        ctx.grid, ctx.axis, ctx.shape, ctx.reduce_grad = grid, axis, table.shape, reduce_grad
        return out.to(dt)

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        g = g.float().contiguous().clone()
        if ctx.reduce_grad:
            ctx.grid.all_reduce(g, ctx.axis).wait()
        dt = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        dt.index_put_((idx[mine],), g[mine], accumulate=True)
        return dt, None, None, None, None, None


class _ModelParallelFn(torch.autograd.Function):
    """The pair of a tensor-parallel block (Megatron's f and g), whose
    activations outside the block are whole on every rank of ``axis`` and
    so are their grads.  At a column-parallel input (``at_output`` False):
    the identity forward, the grad all-reduced over ``axis`` backward (each
    rank's matmul gives its term).  At a row-parallel output (True): the
    ranks' partial sums all-reduced over ``axis`` in fp32 and cast once to
    the input's dtype forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, grid, axis, at_output):
        ctx.grid, ctx.axis, ctx.at_output = grid, axis, at_output
        if not at_output:
            return x
        s = x.float().contiguous().clone()
        grid.all_reduce(s, axis).wait()
        return s.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.at_output:
            g = g.contiguous().clone()
            ctx.grid.all_reduce(g, ctx.axis).wait()
        return g, None, None, None


def copy_to_model(x: torch.Tensor, grid, axis: str) -> torch.Tensor:
    """``x`` (whole on every rank of ``axis``) entering a column-parallel
    product: its grad is all-reduced over ``axis`` in the backward."""
    return _ModelParallelFn.apply(x, grid, axis, False) if grid.size(axis) > 1 else x


def sum_from_model(x: torch.Tensor, grid, axis: str) -> torch.Tensor:
    """A row-parallel product's partial output, summed over ``axis`` in fp32."""
    return _ModelParallelFn.apply(x, grid, axis, True) if grid.size(axis) > 1 else x


class _RowsFn(torch.autograd.Function):
    """Rows of a tensor whose grad is whole on every rank of ``axis``:
    ``split`` takes this rank's block of ``size(axis)`` equal row blocks
    (backward: the blocks' grads all-gathered whole); otherwise the blocks
    are all-gathered (backward: this rank's block of the grad, whole
    already)."""

    @staticmethod
    def forward(ctx, x, grid, axis, split):
        ctx.grid, ctx.axis, ctx.split = grid, axis, split
        if split:
            return x.chunk(grid.size(axis))[grid.index(axis)].contiguous()
        return grid.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        grid, axis = ctx.grid, ctx.axis
        if ctx.split:
            return grid.all_gather(g.contiguous(), axis), None, None, None
        return g.chunk(grid.size(axis))[grid.index(axis)].contiguous(), None, None, None


def split_rows(x: torch.Tensor, grid, axis: str) -> torch.Tensor:
    return _RowsFn.apply(x, grid, axis, True) if grid.size(axis) > 1 else x


def gather_rows(x: torch.Tensor, grid, axis: str) -> torch.Tensor:
    return _RowsFn.apply(x, grid, axis, False) if grid.size(axis) > 1 else x


class _AllToAllFn(torch.autograd.Function):
    """``ProcessGrid.all_to_all`` over ``axis``; its backward is the same
    all-to-all on the grad (the exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, x, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        return grid.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_to_all(g.contiguous(), ctx.axis), None, None


def all_to_all(x: torch.Tensor, grid, axis: str) -> torch.Tensor:
    """The equal-split all-to-all of ``x``'s dim 0 over ``axis``, differentiably."""
    return _AllToAllFn.apply(x, grid, axis) if grid.size(axis) > 1 else x


class _GridMeanFn(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``axis``.  Backward: the grad
    summed over ``grad_axis`` (the axis whose ranks' losses are terms of the
    step's loss; None: the loss is whole on every rank) and divided by the
    rank count, so each rank's statistic gets its share of the whole
    loss's grad."""

    @staticmethod
    def forward(ctx, x, grid, axis, grad_axis):
        ctx.grid, ctx.grad_axis, ctx.n = grid, grad_axis, grid.size(axis)
        s = x.contiguous().clone()
        grid.all_reduce(s, axis).wait()
        return s / ctx.n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.grad_axis is not None:
            ctx.grid.all_reduce(g, ctx.grad_axis).wait()
        return g / ctx.n, None, None, None


def grid_mean(x: torch.Tensor, grid, axis: str, grad_axis: Optional[str]) -> torch.Tensor:
    return _GridMeanFn.apply(x, grid, axis, grad_axis) if grid.size(axis) > 1 else x


class _VocabParallelCEFn(torch.autograd.Function):
    """Masked token cross-entropy over logits whose vocab is sharded over
    ``axis`` ([..., V/M] fp32 on each rank): the row max, the sum of
    exponentials and the target's logit are all-reduced over ``axis``; the
    backward is analytic, each rank's softmax minus its one-hot, so no
    collective runs in it.  Returns this rank's share of the masked mean
    (the same on every rank of ``axis``)."""

    @staticmethod
    def forward(ctx, logits, labels, mask, denom, grid, axis):
        V = logits.shape[-1]
        lo = grid.index(axis) * V
        m = logits.max(dim=-1).values
        grid.all_reduce(m, axis, op="max").wait()
        e = torch.exp(logits - m[..., None])
        sum_e = e.sum(dim=-1)
        grid.all_reduce(sum_e, axis).wait()
        mine = (labels >= lo) & (labels < lo + V)
        idx = torch.where(mine, labels - lo, torch.zeros_like(labels)).long()
        gold = torch.where(mine, torch.gather(logits, -1, idx[..., None])[..., 0], torch.zeros((), device=logits.device))
        grid.all_reduce(gold, axis).wait()
        lse = m + torch.log(sum_e)
        w = mask.float() / denom
        ctx.save_for_backward(logits, lse, idx, mine, w)
        return ((lse - gold) * w).sum()

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine, w = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, idx[..., None], -mine.float()[..., None])
        return d * (w * g)[..., None], None, None, None, None, None


class Sharding:
    """The compute side of a tensor-parallel placement on this rank: which
    leaves are sharded over which axes (``placement``, the whole tree's), and
    the collectives that gather a weight for a computation and scatter its
    grad back."""

    def __init__(self, grid, placement: dict, model_axis: str = "model"):
        self.grid, self.placement, self.axis = grid, placement, model_axis

    def gather(self, t: torch.Tensor, placed: tuple, keep: tuple = ()) -> torch.Tensor:
        """``t`` (this rank's block) whole along every sharded dim whose axis
        is not in ``keep``, differentiably (its grad reduce-scattered back)."""
        for dim, axis in enumerate(placed):
            if axis is not None and axis not in keep and self.grid.size(axis) > 1:
                t = _GatherFn.apply(t, self.grid, axis, dim)
        return t

    def layers(self, key: str, layers: list) -> list:
        """A stacked LSTM's layers for the column-shard cells: gathered over
        ``data`` (FSDP), kept in their ``model`` column blocks."""
        return [{n: self.gather(p[n], pl[n], keep=(self.axis,)) for n in p}
                for p, pl in zip(layers, self.placement[key])]

    def embed(self, key: str, table: torch.Tensor, tokens: torch.Tensor, dt: torch.dtype,
              reduce_grad: bool = True) -> torch.Tensor:
        """The rows of ``tokens`` of embedding ``key`` in ``dt``: a masked
        lookup in this rank's vocab block, summed over ``model``; the
        output's grad summed over ``model`` in the backward unless it is
        whole on every rank already (``reduce_grad`` False)."""
        placed = self.placement[key]["table"]
        table = self.gather(table, placed, keep=(self.axis,))
        if placed[0] == self.axis and self.grid.size(self.axis) > 1:
            return _VocabEmbedFn.apply(table, tokens, self.grid, self.axis, dt, reduce_grad)
        return table[tokens.long()].to(dt)

    def head(self, head: dict) -> dict:
        """The head's weights for eq. 1-5: ``w_alpha`` and ``w_c`` whole (the
        ``luong_attn`` kernel takes them whole), ``f_c`` in its vocab block."""
        placed = self.placement["head"]
        return {n: self.gather(w, placed[n], keep=(self.axis,) if n == "f_c" else ()) for n, w in head.items()}

    def step_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of its data shard's rows ``t`` (block
        ``index(model)`` of ``size(model)``): the rows it runs eq. 1-4 on at
        each input-feeding step, the paper's head data-parallel per step.  The
        slice's backward leaves the other blocks' grads zero: this rank's term
        of the sum over ``model``."""
        M = self.grid.size(self.axis)
        if t.shape[0] % M:
            raise ValueError(f"{t.shape[0]} rows of a data shard do not split into {M} blocks over {self.axis!r}")
        b = t.shape[0] // M
        m = self.grid.index(self.axis)
        return t[m * b:(m + 1) * b]

    def step_cells(self, layers: list, dt: torch.dtype, stage_kernel: str):
        """The input-feeding decoder's step-major cells on ``layers`` (this
        rank's column shards): ``core/pipeline.py::ShardCells``, each cell
        followed by its all-gather of h over ``model``."""
        from repro_torch.core.pipeline import ShardCells  # local: pipeline imports this module

        return ShardCells(self.grid, self.axis, layers, dt, stage_kernel)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`step_rows`: every rank's row block, whole over
        ``model``, differentiably (one all-gather; its grad reduce-scattered)."""
        return self.gather(t, (self.axis,) + (None,) * (t.dim() - 1))

    @property
    def vocab_parallel(self) -> bool:
        return self.placement["head"]["f_c"][1] == self.axis and self.grid.size(self.axis) > 1

    def cross_entropy(self, logits, labels, mask, total=None):
        """(this rank's share of the masked mean, denom) over ``logits`` in
        this rank's vocab block, as ``models.common.softmax_cross_entropy``
        over the whole vocab."""
        count = mask.float().sum()
        denom = torch.clamp(count if total is None else total(count), min=1.0)
        return _VocabParallelCEFn.apply(logits.float(), labels, mask, denom, self.grid, self.axis), denom


# ---------------------------------------------------------------------------
# the paper's phase boundary
# ---------------------------------------------------------------------------


class _Identity:
    """No reshard: the head runs on the backbone's rows."""

    splits_rows = False

    def __call__(self, x):
        return x

    def rows(self, t):
        return t


class _TopStageOnly:
    """MODEL on a model axis above 1: the top stage runs the head on its data
    shard's rows; the other stages hold none."""

    def __init__(self, grid):
        self.top = grid.index("model") == grid.size("model") - 1

    def __call__(self, x):
        return x if self.top else x[:0]

    def rows(self, t):
        return t if self.top else t[:0]


class _ScatterFn(torch.autograd.Function):
    """Forward: the top stage's [B, ...] rows, as M blocks of B/M rows, to the
    M ranks of its ``model`` row (the other ranks pass a placeholder of the
    same shape).  Backward: the blocks' grads gathered back to the top
    stage."""

    @staticmethod
    def forward(ctx, x, grid):
        M = grid.size("model")
        top = M - 1
        b = x.shape[0] // M
        ctx.grid, ctx.shape = grid, x.shape
        out = x.new_empty((b, *x.shape[1:]))
        grid.scatter(out, list(x.split(b)) if grid.index("model") == top else None, "model", src=top)
        return out

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        M = grid.size("model")
        top = grid.index("model") == M - 1
        outs = [g.new_empty(g.shape) for _ in range(M)] if top else None
        grid.gather(g.contiguous(), outs, "model", dst=M - 1)
        return (torch.cat(outs) if top else g.new_zeros(ctx.shape)), None


class _RowBlock:
    """HYBRID on the tensor-parallel backbone: every ``model`` rank of data
    shard d holds its rows whole, and rank (d, m) keeps block m of them
    (block d*M + m of the batch, the order of JAX's ``P(all_axes)``).  The
    slice's backward leaves the other blocks' grads zero: each rank's term of
    the sum over ``model`` that the backbone's reduce-scatters take."""

    def __init__(self, grid):
        self.grid = grid

    def __call__(self, x):
        return self.rows(x)

    def rows(self, t):
        b = t.shape[0] // self.grid.size("model")
        m = self.grid.index("model")
        return t[m * b:(m + 1) * b]


class _ScatterToGrid(_RowBlock):
    """HYBRID on a model axis above 1 of the pipeline: the rows of data shard
    d, held by its top stage, go to the ranks (d, 0..M-1), rank (d, m)
    taking block m, as :class:`_RowBlock` lays them out."""

    def __call__(self, x):
        return _ScatterFn.apply(x, self.grid)


def phase_boundary_fn(strategy: Strategy, grid: Optional[object], tensor_parallel: bool = False):
    """The reshard applied to the backbone's outputs (S and H of the seq2seq
    model) before the attention-softmax phase.  The returned object maps a
    backbone output to this rank's head rows (``pb(x)``), and a tensor of the
    backbone's batch rows that every rank holds to the same head rows
    (``pb.rows(t)``: the masks and labels).

    HYBRID: batch goes from ``data`` shards to shards over *all* ranks, the
    model-parallel stages becoming data-parallel replicas: the paper's
    hand-off, one scatter in the forward and one gather in the backward.
    SINGLE/DATA: the identity.  MODEL: the identity on the top stage, no rows
    elsewhere.  On the ``tensor_parallel`` backbone (whose output every
    ``model`` rank holds): HYBRID, each rank's block of its data shard's rows;
    MODEL and HYBRID_OPT, the identity (the head keeps the ``data``
    sharding, JAX ``strategy.py:248-255``)."""
    if grid is None or grid.size("model") == 1 or strategy in (Strategy.SINGLE, Strategy.DATA, Strategy.HYBRID_OPT):
        return _Identity()
    if tensor_parallel:
        return _RowBlock(grid) if strategy == Strategy.HYBRID else _Identity()
    if strategy == Strategy.HYBRID:
        return _ScatterToGrid(grid)
    return _TopStageOnly(grid)


class _RowSplit(_RowBlock):
    """HYBRID on an LM's tensor-parallel trunk (whose output, and its grad,
    every ``model`` rank holds whole): rank (d, m) keeps block m of data
    shard d's rows, as :class:`_RowBlock` lays them out, and the blocks'
    grads are all-gathered back whole in the backward."""

    splits_rows = True

    def __call__(self, x):
        return split_rows(x, self.grid, "model")


def lm_phase_boundary(strategy: Strategy, grid: Optional[object], tensor_parallel: bool):
    """The phase boundary of an LM's step (``repro/core/strategy.py:229-256``
    on the port's ranks): before the LM head, HYBRID on a ``model`` axis
    above 1 spreads the rows over every rank (:class:`_RowSplit`); every
    other layout keeps them where they are (MODEL and HYBRID_OPT run the
    vocab-parallel head on the data shard's rows)."""
    if grid is None or not tensor_parallel or strategy != Strategy.HYBRID or grid.size("model") == 1:
        return _Identity()
    return _RowSplit(grid)
