"""Training step factory and a small host loop (the port of the seq2seq half
of ``repro/train/trainer.py``).

:func:`make_train_step` builds the step for a model config and an
:class:`~repro_torch.core.plan.ExecutionPlan`: forward and backward over the
plan's microbatches with the grads summed in fp32, global-norm clipping, the
optimizer update.  On a process grid every rank runs the step on the same
global batch: it computes on its rows (and its pipeline stage's layers), and
the grads of the leaves it owns are all-reduced over their axes (DATA: every
grad over the grid; HYBRID: the head over the grid, the backbone and
embeddings over ``data``; MODEL: all over ``data``).  Mixed precision enters
through the plan's ``compute_dtype``: the weights stay fp32 masters, the
model casts them at each use, and their grads come back fp32.  fp16 adds
dynamic loss scaling held in the train state: an overflowed step leaves
params and optimizer state as they were and halves the scale.  The step runs
eagerly; there is no ``jit``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models import seq2seq as s2s
from repro_torch.models.common import resolve_device, tree_leaves, tree_map
from repro_torch.optim.optimizers import OptState, apply_updates


class LossScale(NamedTuple):
    """Dynamic loss-scale state (fp16 only).

    ``scale`` multiplies the loss before backward so small fp16 gradients
    survive the half-precision backward; grads are unscaled in fp32 before
    the optimizer.  ``good_steps`` counts consecutive overflow-free steps;
    after ``plan.loss_scale_growth`` of them the scale doubles, and any
    overflow halves it (floor 1.0) and resets the streak."""

    scale: torch.Tensor  # fp32 scalar
    good_steps: torch.Tensor  # int32 scalar


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    scaling: Optional[LossScale] = None


def init_train_state(params, optimizer, plan: Optional[ExecutionPlan] = None, cfg=None) -> TrainState:
    """``scaling`` is present iff the plan resolves to fp16 compute."""
    scaling = None
    if plan is not None and plan.fp16(cfg):
        dev = tree_leaves(params)[0].device
        scaling = LossScale(
            scale=torch.tensor(plan.loss_scale_init, dtype=torch.float32, device=dev),
            good_steps=torch.zeros((), dtype=torch.int32, device=dev),
        )
    return TrainState(params=params, opt_state=optimizer.init(params), scaling=scaling)


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (``MTBatchIterator``'s) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class _GradSync:
    """The plan's collectives on a grad tree's leaves (``tree_leaves`` order):
    each leaf this rank owns is summed over its role's axis
    (:meth:`ExecutionPlan.leaf_roles`).  One ``all_reduce`` per leaf in every
    mode (at once, one microbatch late, or by buckets), so the sums are the
    same bits whichever mode starts them.  Without a grid nothing is called."""

    def __init__(self, plan: ExecutionPlan):
        self.plan, self.grid = plan, plan.mesh
        self.roles = None

    def bind(self, params) -> None:
        if self.roles is None and self.grid is not None:
            self.roles = self.plan.leaf_roles(params)
            m = self.grid.index(self.plan.model_axis)
            self.mine = [r.axis is not None and r.owner in (None, m) for r in self.roles]

    def reduce(self, leaves: list, positions) -> list:
        """Start the all-reduces of ``leaves[i]`` for i in ``positions`` (in
        place); returns the pending handles."""
        if self.grid is None:
            return []
        return [self.grid.all_reduce(leaves[i], self.roles[i].axis) for i in positions if self.mine[i]]

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the loss -> the grid's loss (reporting)."""
        axis = self.plan.loss_axis()
        if axis is not None:
            loss = loss.clone()
            self.grid.all_reduce(loss, axis).wait()
        return loss

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every leaf, each counted once: the
        squares of the leaves a stage owns summed over the ``model`` axis
        (the others' zeros), the replicated leaves' taken as they are."""
        sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(grads)]
        axis = self.plan.model_axis
        if self.grid is not None and self.grid.size(axis) > 1:
            owned = [i for i, r in enumerate(self.roles) if r.owner is not None]
            if owned:
                vec = torch.stack([sq[i] for i in owned])
                self.grid.all_reduce(vec, axis).wait()
                for j, i in enumerate(owned):
                    sq[i] = vec[j]
        return torch.sqrt(sum(sq))

    def all_finite(self, grads) -> bool:
        bad = torch.stack([(~torch.isfinite(g)).any() for g in tree_leaves(grads)]).any().float()
        if self.grid is not None and self.grid.world > 1:
            self.grid.all_reduce(bad, "all").wait()
        return bool(bad == 0)


def _wait(handles) -> None:
    for h in handles:
        h.wait()


def make_loss_fn(cfg: ModelConfig, plan: ExecutionPlan):
    """(params, batch, generator) -> (loss, {"denom"}), computed in the
    plan's compute dtype on the plan's ``stage_kernel``.  ``batch`` is the
    global (micro)batch; each rank computes on its rows (``shard_batch``),
    through the plan's backbone and phase boundary, and returns its share
    of the global masked mean (the token count summed over the grid), so
    the ranks' losses and grads sum to the single-process ones."""
    if cfg.family != "seq2seq":
        raise NotImplementedError(f"training the {cfg.family!r} family is not ported yet")
    resolved = plan.resolve_compute_dtype(cfg)
    if resolved != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=resolved)
    if cfg.input_feeding and plan.mesh is not None and plan.mesh.size(plan.model_axis) > 1:
        raise NotImplementedError(
            "input feeding on a model axis above 1: its decoder cannot run as the wavefront (the paper's §3.2) "
            "and the tensor-parallel backbone is not ported (ROADMAP queue 1 item 4)")
    backbone = None if cfg.input_feeding else plan.backbone(cfg)
    pb = plan.phase_boundary()
    axis = plan.loss_axis()
    total = None
    if axis is not None:
        def total(count):
            count = count.detach().clone()
            plan.mesh.all_reduce(count, axis).wait()
            return count

    def loss_fn(params, batch, generator):
        batch = plan.shard_batch(batch)
        b = s2s.Seq2SeqBatch(
            src=batch["src"], tgt_in=batch["tgt_in"], tgt_out=batch["tgt_out"],
            src_mask=batch["src_mask"], tgt_mask=batch["tgt_mask"],
        )
        kw = dict(generator=generator, stage_kernel=plan.stage_kernel, total=total)
        if cfg.input_feeding:
            kw["rows"] = plan.shard_rows(b.src.shape[0])
        else:
            kw["phase_boundary"] = pb
            if backbone is not None:
                kw["backbone"] = backbone
        loss, extras = s2s.forward(params, cfg, b, **kw)
        return loss, {"denom": extras["denom"]}

    return loss_fn


def _value_and_grad(loss_fn, params, batch, generator, scale=None):
    """(loss, extras, grads) of one microbatch; with ``scale`` the backward
    runs on loss * scale and the grads come back scaled."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, extras = loss_fn(live, batch, generator)
    target = loss if scale is None else loss * scale.to(loss.dtype)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(target, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves))
    return loss.detach(), {k: v.detach() for k, v in extras.items()}, tree_map(lambda _: next(it), params)


def make_grad_fn(cfg: ModelConfig, plan: ExecutionPlan):
    """(params, batch, generator[, scale]) -> (loss, extras, grads) under the
    plan's microbatch schedule; on a grid the grads of the leaves this rank
    owns are summed over their axes, the loss is the grid's.

    * ``plan.accum_steps == 1`` (one batch, or a pipelined plan whose
      microbatches interleave inside ONE wavefront): one forward/backward.
    * otherwise the batch splits into ``accum_steps`` microbatches, run one
      after another; each one's grads are all-reduced and summed in fp32
      from zeros, and divided by the count at the end; the reported loss is
      the mean of the microbatch losses.
    * ``plan.overlap``: each microbatch's head grads are all-reduced
      asynchronously and folded into the sum one microbatch LATE, after the
      next microbatch's forward and backward, which hide the transfer (the
      delayed sync at the paper's phase boundary).
    * ``plan.bucket_bytes``: the same delay for every grad, started bucket by
      bucket (``plan.grad_buckets``).  Both only move when each all-reduce
      runs: the sums are bitwise those of the plain loop.
    * ``scale`` (fp16 loss scaling): each microbatch's loss is multiplied
      by it before backward; the summed grads are divided by
      ``accum * scale`` in fp32.  The reported loss is the unscaled mean.
    """
    loss_fn = make_loss_fn(cfg, plan)
    accum = plan.accum_steps
    sync = _GradSync(plan)

    def grads_of(params, batch, generator=None, scale=None):
        sync.bind(params)
        n = len(tree_leaves(params))
        if accum == 1:
            loss, extras, grads = _value_and_grad(loss_fn, params, batch, generator, scale)
            _wait(sync.reduce(tree_leaves(grads), range(n)))
            if scale is not None:
                grads = tree_map(lambda g: g.float() / scale, grads)
            return sync.loss(loss), extras, grads
        if plan.overlap and plan.bucket_bytes is not None:
            late = [i for bk in plan.grad_buckets(params) for i in bk["leaves"]]
        elif plan.overlap:
            head = ExecutionPlan.split_head(params)[0]
            late = [i for i, key in enumerate(k for k, v in params.items() for _ in tree_leaves(v)) if key in head]
        else:
            late = []
        now = sorted(set(range(n)) - set(late))
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)]
        pending, loss_sum, denom = None, 0.0, 0.0

        def fold(leaves, positions):
            for i in positions:
                gsum[i] = gsum[i] + leaves[i]

        for mb in plan.split_micro(batch):
            loss, extras, g = _value_and_grad(loss_fn, params, mb, generator, scale)
            leaves = [x.float() for x in tree_leaves(g)]
            _wait(sync.reduce(leaves, now))
            fold(leaves, now)
            handles = sync.reduce(leaves, late)  # in flight under the next microbatch
            if pending is not None:
                _wait(pending[0])
                fold(pending[1], late)
            pending = (handles, leaves)
            loss_sum = loss_sum + loss
            denom = denom + extras["denom"]
        _wait(pending[0])  # the last microbatch's sync is exposed
        fold(pending[1], late)
        it = iter(gsum)
        gsum = tree_map(lambda _: next(it), params)
        if scale is None:
            grads = tree_map(lambda a: a / accum, gsum)
        else:
            inv = 1.0 / (scale * accum)
            grads = tree_map(lambda a: a * inv, gsum)
        return sync.loss(loss_sum / accum), {"denom": denom}, grads

    grads_of.sync = sync
    return grads_of


def make_train_step(cfg: ModelConfig, optimizer, *, plan: Optional[ExecutionPlan] = None, clip_norm: float = 5.0):
    """train_step(state, batch, lr_scale, generator) -> (state, metrics).
    ``batch`` holds the global batch's tensors on the params' device (every
    rank of a grid passes the same batch); ``generator`` (on that device, the
    same seed on every rank) drives dropout.  Clipping uses the grid's global
    norm."""
    plan = plan or ExecutionPlan()
    grads_of = make_grad_fn(cfg, plan)
    sync = grads_of.sync
    fp16 = plan.fp16(cfg)

    def clip(grads):
        norm = sync.global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads), norm

    def train_step(state: TrainState, batch: dict, lr_scale: float, generator: Optional[torch.Generator]):
        if not fp16:
            loss, extras, grads = grads_of(state.params, batch, generator)
            grads, gnorm = clip(grads)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params, lr_scale)
            params = apply_updates(state.params, updates)
            metrics = {"loss": loss, "grad_norm": gnorm, "tokens": extras["denom"]}
            return TrainState(params=params, opt_state=opt_state, scaling=state.scaling), metrics

        # fp16: grads_of scales each microbatch's loss and returns unscaled
        # fp32 grads; a nonfinite leaf on any rank means the scaled backward
        # overflowed: keep params and optimizer state as they were and halve
        # the scale.  A streak of plan.loss_scale_growth clean steps doubles it.
        scale = state.scaling.scale
        loss, extras, grads = grads_of(state.params, batch, generator, scale)
        finite = sync.all_finite(grads)
        grads, gnorm = clip(grads)
        if finite:
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params, lr_scale)
            params = apply_updates(state.params, updates)
            good = state.scaling.good_steps + 1
            grow = bool(good >= plan.loss_scale_growth)
            new_scale = scale * 2.0 if grow else scale
            if grow:
                good = torch.zeros_like(good)
        else:
            params, opt_state = state.params, state.opt_state
            new_scale = torch.clamp(scale * 0.5, min=1.0)
            good = torch.zeros_like(state.scaling.good_steps)
        metrics = {
            "loss": loss, "grad_norm": gnorm, "tokens": extras["denom"],
            "loss_scale": new_scale, "overflow": 0.0 if finite else 1.0,
        }
        return TrainState(params=params, opt_state=opt_state, scaling=LossScale(new_scale, good)), metrics

    return train_step


class Trainer:
    """Minimal host loop: steps on ``device`` (the card by default; on a grid,
    the grid's device) from an iterator of numpy batches, with dropout drawn
    from a ``torch.Generator`` seeded from ``seed``.  On a grid every rank
    runs it on the same batches and only rank 0 logs."""

    def __init__(self, cfg: ModelConfig, optimizer, train_iter, *, plan: Optional[ExecutionPlan] = None,
                 params=None, clip_norm: float = 5.0, seed: int = 0, device="cuda"):
        plan = plan or ExecutionPlan()
        self.device = plan.mesh.device if plan.mesh is not None else resolve_device(device)
        self.rank = plan.mesh.rank if plan.mesh is not None else 0
        if params is None:
            params = s2s.init_seq2seq(seed, cfg, device=self.device)
        else:
            params = tree_map(lambda t: t.to(self.device), params)
        self.plan = plan
        self.step_fn = make_train_step(cfg, optimizer, plan=plan, clip_norm=clip_norm)
        self.state = init_train_state(params, optimizer, plan=plan, cfg=cfg)
        self.train_iter = train_iter
        self.lr_scale = 1.0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.history = []

    def run(self, steps: int, log_every: int = 50, log=print):
        """Take ``steps`` steps; every ``log_every`` steps log a line (rank 0)
        and append the step's loss, grad norm and wall time to ``history``."""
        t0 = time.perf_counter()
        tokens = 0.0
        for i in range(steps):
            ts = time.perf_counter()
            batch = batch_to_device(next(self.train_iter), self.device)
            self.state, metrics = self.step_fn(self.state, batch, self.lr_scale, self.generator)
            tokens += float(metrics["tokens"])  # waits for the step
            if (i + 1) % log_every == 0:
                loss = float(metrics["loss"])
                now = time.perf_counter()
                dt = now - t0
                self.history.append({"step": i + 1, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                                     "tokens": float(metrics["tokens"]), "step_s": now - ts,
                                     "tok_per_s": tokens / dt})
                if self.rank == 0:
                    log(f"step {i+1:5d}  loss {loss:.4f}  tok/s {tokens/dt:,.0f}  lr_scale {self.lr_scale:.3f}")
        return self.state

    def params(self):
        """The whole parameter tree, each leaf from the rank that owns it
        (a collective: every rank of a grid calls it)."""
        return self.plan.gather_params(self.state.params)
