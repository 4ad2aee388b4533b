"""Training step factory and a small host loop (the port of the meshless,
seq2seq half of ``repro/train/trainer.py``).

:func:`make_train_step` builds the step for a model config and an
:class:`~repro_torch.core.plan.ExecutionPlan`: forward and backward over the
plan's microbatches with the grads summed in fp32, global-norm clipping, the
optimizer update.  Mixed precision enters through the plan's
``compute_dtype``: the weights stay fp32 masters, the model casts them at each
use, and their grads come back fp32.  fp16 adds dynamic loss scaling held in
the train state: an overflowed step leaves params and optimizer state as they
were and halves the scale.  The step runs eagerly; there is no ``jit``.
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
from repro_torch.optim.optimizers import OptState, apply_updates, clip_by_global_norm


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


def make_loss_fn(cfg: ModelConfig, plan: ExecutionPlan):
    """(params, batch, generator) -> (mean loss, {"denom"}), computed in the
    plan's compute dtype on the plan's ``stage_kernel``."""
    if cfg.family != "seq2seq":
        raise NotImplementedError(f"training the {cfg.family!r} family is not ported yet")
    resolved = plan.resolve_compute_dtype(cfg)
    if resolved != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=resolved)

    def loss_fn(params, batch, generator):
        b = s2s.Seq2SeqBatch(
            src=batch["src"], tgt_in=batch["tgt_in"], tgt_out=batch["tgt_out"],
            src_mask=batch["src_mask"], tgt_mask=batch["tgt_mask"],
        )
        loss, extras = s2s.forward(params, cfg, b, generator=generator, stage_kernel=plan.stage_kernel)
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
    plan's microbatch schedule.

    * ``plan.accum_steps == 1``: one forward/backward.
    * otherwise the batch splits into ``accum_steps`` microbatches, run one
      after another; their grads are summed in fp32 from the first one on
      and divided by the count, and the reported loss is the mean of the
      microbatch losses.
    * ``scale`` (fp16 loss scaling): each microbatch's loss is multiplied
      by it before backward; the summed grads are divided by
      ``accum * scale`` in fp32.  The reported loss is the unscaled mean.
    """
    loss_fn = make_loss_fn(cfg, plan)
    accum = plan.accum_steps

    def grads_of(params, batch, generator=None, scale=None):
        if accum == 1:
            loss, extras, grads = _value_and_grad(loss_fn, params, batch, generator, scale)
            if scale is not None:
                grads = tree_map(lambda g: g.float() / scale, grads)
            return loss, extras, grads
        gsum, loss_sum, denom = None, 0.0, 0.0
        for mb in plan.split_micro(batch):
            loss, extras, g = _value_and_grad(loss_fn, params, mb, generator, scale)
            gsum = tree_map(lambda x: x.float(), g) if gsum is None else tree_map(lambda a, b: a + b.float(), gsum, g)
            loss_sum = loss_sum + loss
            denom = denom + extras["denom"]
        if scale is None:
            grads = tree_map(lambda a: a / accum, gsum)
        else:
            inv = 1.0 / (scale * accum)
            grads = tree_map(lambda a: a * inv, gsum)
        return loss_sum / accum, {"denom": denom}, grads

    return grads_of


def make_train_step(cfg: ModelConfig, optimizer, *, plan: Optional[ExecutionPlan] = None, clip_norm: float = 5.0):
    """train_step(state, batch, lr_scale, generator) -> (state, metrics).
    ``batch`` holds tensors on the params' device; ``generator`` (on that
    device) drives dropout."""
    plan = plan or ExecutionPlan()
    grads_of = make_grad_fn(cfg, plan)
    fp16 = plan.fp16(cfg)

    def train_step(state: TrainState, batch: dict, lr_scale: float, generator: Optional[torch.Generator]):
        if not fp16:
            loss, extras, grads = grads_of(state.params, batch, generator)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params, lr_scale)
            params = apply_updates(state.params, updates)
            metrics = {"loss": loss, "grad_norm": gnorm, "tokens": extras["denom"]}
            return TrainState(params=params, opt_state=opt_state, scaling=state.scaling), metrics

        # fp16: grads_of scales each microbatch's loss and returns unscaled
        # fp32 grads; a nonfinite leaf anywhere means the scaled backward
        # overflowed: keep params and optimizer state as they were and halve
        # the scale.  A streak of plan.loss_scale_growth clean steps doubles it.
        scale = state.scaling.scale
        loss, extras, grads = grads_of(state.params, batch, generator, scale)
        finite = bool(torch.stack([torch.isfinite(g).all() for g in tree_leaves(grads)]).all())
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
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
    """Minimal host loop: steps on ``device`` (the card by default) from an
    iterator of numpy batches, with dropout drawn from a ``torch.Generator``
    seeded from ``seed``."""

    def __init__(self, cfg: ModelConfig, optimizer, train_iter, *, plan: Optional[ExecutionPlan] = None,
                 params=None, clip_norm: float = 5.0, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        plan = plan or ExecutionPlan()
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
        """Take ``steps`` steps; every ``log_every`` steps log a line and
        append the step's loss, grad norm and wall time to ``history``."""
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
                log(f"step {i+1:5d}  loss {loss:.4f}  tok/s {tokens/dt:,.0f}  lr_scale {self.lr_scale:.3f}")
        return self.state
