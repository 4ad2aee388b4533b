"""Training step factory and a small host loop (the port of
``repro/train/trainer.py``).

The seq2seq family trains on every plan, and so do the dense and MoE LM
families (``models/transformer.py::forward_train``: the CE plus the MoE
load-balance term, remat per layer group): DATA, and the tensor-parallel
MODEL, HYBRID and HYBRID_OPT with the expert-parallel MoE
(``core/plan.py::check_lm_plan`` refuses the grids their blocks do not
split over).

:func:`make_train_step` builds the step for a model config and an
:class:`~repro_torch.core.plan.ExecutionPlan`: forward and backward over the
plan's microbatches with the grads summed in fp32, global-norm clipping, the
optimizer update.  On a process grid every rank runs the step on the same
global batch: it computes on its rows (and its pipeline stage's layers), and
the grads of the leaves it owns are all-reduced over their axes (DATA: every
grad over the grid; HYBRID: the head over the grid, the backbone and
embeddings over ``data``; MODEL: all over ``data``).  On the tensor-parallel
layouts the params, grads and optimizer moments are this rank's blocks
(``ExecutionPlan.shard_params``): a grad is summed over the axes that do not
shard its leaf, an FSDP leaf's grad arrives reduce-scattered over ``data``,
and Adam steps on the blocks.  A config with input feeding runs on every
plan: on the tensor-parallel ones (a pipelined MODEL/HYBRID plan on a
``model`` axis above 1 runs as one, ``ExecutionPlan.for_config``) its
decoder runs step-major on the column-shard cells, eq. 1-4 of each step
on the rank's row block.  Mixed precision enters
through the plan's ``compute_dtype``: the weights stay fp32 masters, the
model casts them at each use, and their grads come back fp32.  fp16 adds
dynamic loss scaling held in the train state: an overflowed step leaves
params and optimizer state as they were and halves the scale.  The step runs
eagerly; there is no ``jit``.  ``donate=True`` (the :class:`Trainer`'s, as
the JAX trainer donates its state) writes each leaf's update into the
params' and moments' own storage, leaf by leaf, with the same numbers, so a
step holds one copy of the state where the functional update holds two.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import strategy as stg
from repro_torch.core.plan import ExecutionPlan, check_lm_plan
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tfm
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
    """A batch of numpy arrays (``MTBatchIterator``'s or ``LMBatchIterator``'s)
    as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class _GradSync:
    """The plan's collectives on a grad tree's leaves (``tree_leaves`` order):
    each leaf this rank owns is summed over its role's axis
    (:meth:`ExecutionPlan.leaf_roles`).  One ``all_reduce`` per leaf in every
    mode (at once, one microbatch late, or by buckets), so the sums are the
    same bits whichever mode starts them.  Without a grid nothing is called."""

    def __init__(self, plan: ExecutionPlan, cfg: ModelConfig):
        self.plan, self.grid, self.cfg = plan.for_config(cfg), plan.mesh, cfg
        self.roles = None

    def bind(self, params) -> None:
        if self.roles is None and self.grid is not None:
            self.roles = self.plan.leaf_roles(params, self.cfg)
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
        """sqrt of the sum of squares of every leaf, each element counted
        once: the squares of the leaves a stage owns summed over the
        ``model`` axis (the others' zeros), of a sharded leaf's blocks over
        the axes that shard it, the replicated leaves' taken as they are."""
        sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(grads)]
        if self.grid is not None:
            groups = {}
            for i, r in enumerate(self.roles):
                axes = set(r.shard) | ({self.plan.model_axis} if r.owner is not None else set())
                axis = stg.axis_name(tuple(a for a in axes if self.grid.size(a) > 1))
                if axis is not None:
                    groups.setdefault(axis, []).append(i)
            for axis in ("model", "data", "all"):  # one order on every rank
                if axis in groups:
                    vec = torch.stack([sq[i] for i in groups[axis]])
                    self.grid.all_reduce(vec, axis).wait()
                    for j, i in enumerate(groups[axis]):
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
    """(params, batch, generator) -> (loss, extras), computed in the plan's
    compute dtype on the plan's ``stage_kernel``.

    seq2seq: extras {"denom"}.  ``batch`` is the global (micro)batch; each
    rank computes on its rows (``shard_batch``), through the plan's backbone
    and phase boundary, and returns its share of the global masked mean (the
    token count summed over the grid), so the ranks' losses and grads sum to
    the single-process ones.

    dense / MoE LM: ``forward_train`` on batch {"tokens", "labels", "mask"}
    with ``stage_kernel`` as the attention and expert-FFN path and each
    layer group recomputed in the backward (remat, as the JAX trainer's
    default); extras {"denom", "aux"} (the MoE load-balance loss summed over
    the layers, 0 for a dense model).  On a grid each rank computes on its
    rows, on the tensor-parallel layouts on its blocks
    (``ExecutionPlan.sharding``), the MoE expert-parallel on every strategy
    but DATA (``repro/train/trainer.py:118-146``), through the plan's LM
    phase boundary (``strategy.lm_phase_boundary``), and returns its share
    of the loss.  The generator is unused."""
    resolved = plan.resolve_compute_dtype(cfg)
    if resolved != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=resolved)
    plan = plan.for_config(cfg)
    if cfg.family != "seq2seq":
        return _lm_loss_fn(cfg, plan)

    sharding = plan.sharding(cfg)
    # under input feeding only a tensor-parallel plan's backbone runs (the encoder's), as the JAX trainer drops it
    backbone = plan.backbone(cfg) if plan.tensor_parallel or not cfg.input_feeding else None
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
        if cfg.input_feeding and not plan.tensor_parallel:
            kw["rows"] = plan.shard_rows(b.src.shape[0])
        else:
            kw["phase_boundary"] = pb
            if backbone is not None:
                kw["backbone"] = backbone
            if sharding is not None:
                kw["sharding"] = sharding
        loss, extras = s2s.forward(params, cfg, b, **kw)
        return loss, {"denom": extras["denom"]}

    return loss_fn


def _lm_loss_fn(cfg: ModelConfig, plan: ExecutionPlan):
    check_lm_plan(plan, cfg)
    S = stg.Strategy
    grid = plan.mesh if plan.mesh is not None and plan.strategy != S.SINGLE else None
    ep = cfg.moe is not None and grid is not None and plan.strategy != S.DATA
    ctx = tfm.RunCtx(mode="train", kernel=plan.stage_kernel, grid=grid, sharding=plan.sharding(cfg),
                     ep_axis=plan.model_axis if ep else None, loss_axis=plan.loss_axis() if grid is not None else None)
    pb = stg.lm_phase_boundary(plan.strategy, grid, plan.tensor_parallel) if grid is not None else None

    def lm_loss_fn(params, batch, generator):
        del generator
        batch = plan.shard_batch(batch)
        loss, extras = tfm.forward_train(params, cfg, batch["tokens"], batch["labels"], batch["mask"], ctx=ctx,
                                         phase_boundary=pb)
        return loss, {"denom": extras["denom"], "aux": extras["aux"]}

    return lm_loss_fn


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
    sync = _GradSync(plan, cfg)

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


UPDATE_CHUNK = 1 << 25  # elements of a leaf updated at once in place: bounds the update's temporaries


def _update_in_place(optimizer, grads, opt_state: OptState, params, lr_scale, clip_scale) -> OptState:
    """``optimizer.update`` on the clipped grads and ``apply_updates``, on
    one slice of UPDATE_CHUNK elements of a leaf at a time, each result
    written into the storage of the param and moments it replaces (the same
    elementwise operations, so the same numbers as the functional step; the
    temporaries are a slice's, not a whole tree's).  Returns the optimizer
    state, whose moment trees are the old ones, updated."""
    per_leaf_v = isinstance(opt_state.v, (dict, list, tuple))  # SGD keeps a scalar
    trees = [params, opt_state.m] + ([opt_state.v] if per_leaf_v else [])
    new_state = opt_state
    for g, *leaves in zip(tree_leaves(grads), *(tree_leaves(t) for t in trees)):
        for g_part, p, m, *v in zip(g.reshape(-1).split(UPDATE_CHUNK),
                                    *(t.view(-1).split(UPDATE_CHUNK) for t in leaves)):
            state = OptState(opt_state.step, [m], v if per_leaf_v else opt_state.v)
            (u,), new_state = optimizer.update([g_part * clip_scale], state, [p], lr_scale)
            m.copy_(new_state.m[0])
            if per_leaf_v:
                v[0].copy_(new_state.v[0])
            p.add_(u)
    return OptState(step=new_state.step, m=opt_state.m, v=opt_state.v if per_leaf_v else new_state.v)


def make_train_step(cfg: ModelConfig, optimizer, *, plan: Optional[ExecutionPlan] = None, clip_norm: float = 5.0,
                    donate: bool = False):
    """train_step(state, batch, lr_scale, generator) -> (state, metrics).
    ``batch`` holds the global batch's tensors on the params' device (every
    rank of a grid passes the same batch); ``generator`` (on that device, the
    same seed on every rank) drives dropout.  Clipping uses the grid's global
    norm.  ``donate``: the step writes the new params and optimizer moments
    into the state's own tensors (:func:`_update_in_place`) and returns a
    state holding them; the state passed in must not be read again."""
    plan = plan or ExecutionPlan()
    grads_of = make_grad_fn(cfg, plan)
    sync = grads_of.sync
    fp16 = plan.fp16(cfg)

    def clip_scale(grads):
        norm = sync.global_norm(grads)
        return torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0), norm

    def update(grads, state: TrainState, lr_scale):
        """(params, opt_state) after the clipped update; and the grad norm."""
        scale, norm = clip_scale(grads)
        if donate:
            return state.params, _update_in_place(optimizer, grads, state.opt_state, state.params, lr_scale,
                                                  scale), norm
        grads = tree_map(lambda g: g * scale, grads)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params, lr_scale)
        return apply_updates(state.params, updates), opt_state, norm

    def train_step(state: TrainState, batch: dict, lr_scale: float, generator: Optional[torch.Generator]):
        if not fp16:
            loss, extras, grads = grads_of(state.params, batch, generator)
            params, opt_state, gnorm = update(grads, state, lr_scale)
            metrics = {"loss": loss, "grad_norm": gnorm, "tokens": extras["denom"]}
            if "aux" in extras:
                metrics["moe_aux"] = extras["aux"]
            return TrainState(params=params, opt_state=opt_state, scaling=state.scaling), metrics

        # fp16: grads_of scales each microbatch's loss and returns unscaled
        # fp32 grads; a nonfinite leaf on any rank means the scaled backward
        # overflowed: keep params and optimizer state as they were and halve
        # the scale.  A streak of plan.loss_scale_growth clean steps doubles it.
        scale = state.scaling.scale
        loss, extras, grads = grads_of(state.params, batch, generator, scale)
        finite = sync.all_finite(grads)
        if finite:
            params, opt_state, gnorm = update(grads, state, lr_scale)
            good = state.scaling.good_steps + 1
            grow = bool(good >= plan.loss_scale_growth)
            new_scale = scale * 2.0 if grow else scale
            if grow:
                good = torch.zeros_like(good)
        else:
            gnorm = clip_scale(grads)[1]
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
    runs it on the same batches and only rank 0 logs.  ``params`` (or the
    seed's: ``init_seq2seq``, or ``init_lm`` for the dense and MoE families)
    are the whole tree; each rank keeps its blocks of it
    (``ExecutionPlan.shard_params``), and its optimizer moments are those
    blocks' own.  Its step donates the state (``make_train_step``), so it
    trains a copy of the ``params`` passed in and leaves them as they are."""

    def __init__(self, cfg: ModelConfig, optimizer, train_iter, *, plan: Optional[ExecutionPlan] = None,
                 params=None, clip_norm: float = 5.0, seed: int = 0, device="cuda"):
        plan = plan or ExecutionPlan()
        self.device = plan.mesh.device if plan.mesh is not None else resolve_device(device)
        self.rank = plan.mesh.rank if plan.mesh is not None else 0
        if params is None:
            init = s2s.init_seq2seq if cfg.family == "seq2seq" else tfm.init_lm
            params = init(seed, cfg, device=self.device)
        else:  # a contiguous copy: the step updates the state in place, a flat slice at a time
            params = tree_map(lambda t: t.detach().to(self.device, copy=True, memory_format=torch.contiguous_format),
                              params)
        self.plan, self.cfg = plan, cfg
        self.step_fn = make_train_step(cfg, optimizer, plan=plan, clip_norm=clip_norm, donate=True)
        params = plan.shard_params(params, cfg)
        self.state = init_train_state(params, optimizer, plan=plan, cfg=cfg)
        self.train_iter = train_iter
        self.lr_scale = 1.0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.history = []

    def run(self, steps: int, log_every: int = 50, log=print):
        """Take ``steps`` steps; every ``log_every`` steps log a line (rank 0)
        and append the step's loss, grad norm and wall time (and an MoE
        model's load-balance loss, ``moe_aux``) to ``history``."""
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
                if "moe_aux" in metrics:
                    self.history[-1]["moe_aux"] = float(metrics["moe_aux"])
                if self.rank == 0:
                    log(f"step {i+1:5d}  loss {loss:.4f}  tok/s {tokens/dt:,.0f}  lr_scale {self.lr_scale:.3f}")
        return self.state

    def params(self):
        """The whole parameter tree, each leaf gathered from the ranks that
        hold its blocks or from the rank that owns it (a collective: every
        rank of a grid calls it)."""
        return self.plan.gather_params(self.state.params, self.cfg)
