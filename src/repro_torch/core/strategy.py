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
HYBRID_OPT beyond the paper: a vocab-sharded head and FSDP; not ported
           (ROADMAP queue 1 item 4)
========== =============================================================

Where the JAX package maps logical axes to mesh axes and lets GSPMD insert
the collectives, the port's ranks hold their own rows and call the
collectives themselves: :func:`phase_boundary_fn` returns the reshard as an
autograd ``Function`` with a collective in each direction.
"""
from __future__ import annotations

import enum
from typing import Optional

import torch


class Strategy(str, enum.Enum):
    SINGLE = "single"
    DATA = "data"
    MODEL = "model"
    HYBRID = "hybrid"
    HYBRID_OPT = "hybrid_opt"


HEAD_KEYS = ("head", "lm_head", "final_norm")  # the attention-softmax part

HYBRID_OPT_NOT_PORTED = ("strategy='hybrid_opt' (vocab-sharded head, FSDP) is not ported: "
                         "ROADMAP queue 1 item 4")


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
# the paper's phase boundary
# ---------------------------------------------------------------------------


class _Identity:
    """No reshard: the head runs on the backbone's rows."""

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


class _ScatterToGrid:
    """HYBRID on a model axis above 1: the rows of data shard d, held by its
    top stage, go to the ranks (d, 0..M-1), rank (d, m) taking block m; so
    global rank d*M + m holds block d*M + m of the batch, the order of JAX's
    ``P(all_axes)``."""

    def __init__(self, grid):
        self.grid = grid
        self.M, self.m = grid.size("model"), grid.index("model")

    def __call__(self, x):
        return _ScatterFn.apply(x, self.grid)

    def rows(self, t):
        b = t.shape[0] // self.M
        return t[self.m * b:(self.m + 1) * b]


def phase_boundary_fn(strategy: Strategy, grid: Optional[object]):
    """The reshard applied to the backbone's outputs (S and H of the seq2seq
    model) before the attention-softmax phase.  The returned object maps a
    backbone output to this rank's head rows (``pb(x)``), and a tensor of the
    backbone's batch rows that every rank holds to the same head rows
    (``pb.rows(t)``: the masks and labels).

    HYBRID: batch goes from ``data`` shards to shards over *all* ranks, the
    model-parallel stages becoming data-parallel replicas: the paper's
    hand-off, one scatter in the forward and one gather in the backward.
    SINGLE/DATA: the identity.  MODEL: the identity on the top stage, no rows
    elsewhere."""
    if strategy == Strategy.HYBRID_OPT and grid is not None:
        raise NotImplementedError(HYBRID_OPT_NOT_PORTED)
    if grid is None or grid.size("model") == 1 or strategy in (Strategy.SINGLE, Strategy.DATA):
        return _Identity()
    if strategy == Strategy.HYBRID:
        return _ScatterToGrid(grid)
    return _TopStageOnly(grid)
