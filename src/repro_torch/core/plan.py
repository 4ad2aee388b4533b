"""The port's execution plans: ``repro.core.plan.ExecutionPlan`` for
training, and the subset of ``repro.core.plan.ServePlan`` that serves the
seq2seq family under the ``encdec_memory`` cache policy and the dense and
MoE LM families under ``full_kv`` and ``window``.

:class:`ExecutionPlan` binds once how a training step executes:

    (strategy, process grid, pipeline stages, microbatches, overlap flags)

* ``strategy`` and ``mesh``: SINGLE/DATA/MODEL/HYBRID/HYBRID_OPT
  (``core/strategy.py``) on a :class:`~repro_torch.launch.mesh.ProcessGrid`
  of ``data x model`` ranks, or None for one process;
* ``use_pipeline`` (with MODEL or HYBRID on a grid): the stacked LSTMs run
  as the wavefront pipeline over the ``model`` ranks (``core/pipeline.py``),
  the k microbatches *interleaved inside one wavefront*, so the
  (NS-1)-tick fill/drain is paid once per step and the trainer does not
  also accumulate (``accum_steps == 1``); ``schedule`` (gpipe, 1f1b,
  zerobubble, interleaved) drives its backward, and ``virtual_stages=v``
  with ``interleaved`` runs v layer chunks per stage on the ring;
* without it, MODEL or HYBRID on a ``model`` axis above 1, and HYBRID_OPT on
  any grid, are the tensor-parallel layouts (:attr:`tensor_parallel`): each
  leaf placed by the JAX rule, a rank storing only its blocks, the backbone
  on column-shard cells (``core/pipeline.py::tensor_parallel_backbone``);
  under input feeding a pipelined MODEL or HYBRID plan on a ``model`` axis
  above 1 runs as its tensor-parallel twin (:meth:`ExecutionPlan.for_config`):
  its decoder runs step-major on the column-shard cells, the head inside
  the recurrence;
* otherwise ``micro_batches`` is the classic gradient accumulation, and
  ``overlap`` delays the all-reduce of each microbatch's head grads (with
  ``bucket_bytes``: of every grad, in size-targeted buckets) by one
  microbatch, so it runs under the next microbatch's compute;
* ``stage_kernel``: ``cuda`` (the fused LSTM cell and Luong head kernels)
  or ``torch`` (the plain math);
* ``compute_dtype``: the activations' dtype (None: the config's); the
  weights, optimizer moments and grad sums stay fp32;
* ``loss_scale_init`` / ``loss_scale_growth``: fp16's dynamic loss scale.

Every validator of the JAX plan is kept.

The dense and MoE LM families train on every strategy (the JAX package's
``make_loss_fn`` for them, ``repro/train/trainer.py:118-146``): DATA with
every leaf whole on each rank, the others tensor-parallel on a ``model``
axis above 1 (and HYBRID_OPT on any grid), each leaf placed by the JAX rule
on ``models/transformer.py::param_specs``; the MoE is expert-parallel on
every strategy but DATA.  The JAX LM loss never reads ``plan.backbone``, so
a pipelined plan runs an LM on its tensor-parallel twin
(:meth:`ExecutionPlan.for_config`).  :func:`check_lm_plan` refuses the
grids whose ``model`` axis does not split the heads, ``ff``, the experts or
the vocabulary (the JAX rule would replicate those dims there).

:meth:`ExecutionPlan.placement` places each leaf (per dim, the grid axis
that shards it, or None): the JAX rule on the tensor-parallel layouts,
nothing sharded on the others, where each rank holds the whole tree.
:meth:`ExecutionPlan.shard_params` cuts a whole tree to this rank's blocks
and :meth:`ExecutionPlan.gather_params` puts it back together;
:meth:`ExecutionPlan.leaf_roles` says which leaves a rank owns (a pipeline
stage its layers, stage 0 the embeddings), which axes shard each and over
which axis its grad is summed.

:class:`ServePlan`:

* ``cache_policy``: ``encdec_memory`` (seq2seq: the encoder states S are
  the cached memory; decode is one decoder-LSTM step plus the Luong head),
  ``full_kv`` (an append-only KV cache) or ``window`` (a rolling KV buffer
  of ``window`` slots); the last two serve the dense and MoE families
  through the static ``ServeEngine``.
* ``max_slots`` is the slot-table size; the decode tick runs all slots and
  masks the inactive ones.
* ``max_len`` is each slot's cache capacity (the source capacity for
  seq2seq).
* ``prefill_chunk``: a source enters ``prefill_chunk`` tokens per step
  while that many remain, then one token per step; the static LM engine
  rounds its cache capacity up to a multiple of it.
* ``admission``: ``static`` admits one batch up front; ``continuous``
  admits from the queue whenever a slot frees.
* ``window``: the rolling buffer's size (``cache_policy="window"`` only).
* ``stage_kernel``: the kernel path, ``cuda`` (the hand-written kernels:
  the Luong head, or the LM's prefill attention and MoE expert FFN) or
  ``torch`` (the plain math).

The ``recurrent`` policy and the paged, mesh-sharded and speculative fields
of the JAX serving plan are not ported: :meth:`ServePlan.for_config` raises
on them by name.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

from repro_torch.core import strategy as stg
from repro_torch.kernels import fit_block
from repro_torch.models.common import tree_leaves, tree_map

CACHE_POLICIES = ("full_kv", "window", "encdec_memory")
ADMISSIONS = ("static", "continuous")
STAGE_KERNELS = ("torch", "cuda")
# ServePlan fields of the JAX plan that serving does not take yet
NOT_PORTED = frozenset({
    "strategy", "mesh", "page_size", "num_pages", "share_prefixes",
    "draft_arch", "draft_len", "acceptance",
})


# training compute precisions; params, optimizer moments and grad sums stay fp32
COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


@dataclass(frozen=True)
class WavefrontSchedule:
    """Clock-tick accounting of the microbatched wavefront.

    With NS stages and k microbatches of sequence length S, microbatch m's
    timestep t occupies global token-step ``u = m*S + t``; stage s computes
    u at tick ``tau = s + u``.  Total ticks ``k*S + NS - 1``: one fill and
    one drain for the whole step, vs ``k*(S + NS - 1)`` when each microbatch
    pays its own bubble."""

    seq_len: int
    num_stages: int
    micro_batches: int = 1

    def __post_init__(self):
        if self.seq_len < 1 or self.num_stages < 1 or self.micro_batches < 1:
            raise ValueError(
                "seq_len/num_stages/micro_batches must all be >= 1, got "
                f"seq_len={self.seq_len}, num_stages={self.num_stages}, "
                f"micro_batches={self.micro_batches}"
            )

    @property
    def ticks(self) -> int:
        return self.micro_batches * self.seq_len + self.num_stages - 1

    @property
    def naive_ticks(self) -> int:
        """Ticks if every microbatch ran its own fill/drain."""
        return self.micro_batches * (self.seq_len + self.num_stages - 1)

    @property
    def fill_drain_ticks(self) -> int:
        return self.num_stages - 1

    @property
    def bubble_fraction(self) -> float:
        """Fraction of ticks any stage spends idle (fill + drain)."""
        return self.fill_drain_ticks / self.ticks


class LeafRole(NamedTuple):
    """How one parameter leaf's grad is made whole on a grid: ``owner`` is
    the ``model`` coordinate that computes it (None: every rank does),
    ``axis`` the grid axis its grad is summed over (None: no sum), and
    ``shard`` the axes that shard it (each rank holds its block)."""

    owner: Optional[int]
    axis: Optional[str]
    shard: tuple = ()


def _paths(tree, prefix=(), sort=False):
    """(path, leaf) pairs: in the port's order (dict insertion), or with
    ``sort`` in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _paths(tree[k], prefix + (k,), sort)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,), sort)
    else:
        yield prefix, tree


def _for_config(method):
    """Runs a plan method whose last argument is a model config on the plan
    that runs that config (:meth:`ExecutionPlan.for_config`)."""

    @functools.wraps(method)
    def run(plan, *args):
        return method(plan.for_config(args[-1]), *args)

    return run


def _placed_leaves(params, placed) -> list:
    """The placement of each leaf of ``params``, in ``tree_leaves`` order."""
    out: list = []
    tree_map(lambda _, p: out.append(p), params, placed)
    return out


def check_lm_plan(plan, cfg) -> None:
    """Raise unless ``plan`` can train the LM ``cfg`` (dense or MoE family):
    on a tensor-parallel plan the ``model`` axis must split the q heads (or
    the grouped layout's kv heads or groups), ``ff``, the experts and the
    vocabulary, which the port's blocks shard without a replicated
    fallback."""
    if cfg.family == "seq2seq":
        return
    plan = plan.for_config(cfg)
    if not plan.tensor_parallel:
        return
    M = plan.mesh.size(plan.model_axis)
    G = cfg.num_heads // cfg.num_kv_heads
    dims = [("num_heads" if cfg.attn_flat else "q groups", cfg.num_heads if cfg.attn_flat else
             (cfg.num_kv_heads if cfg.num_kv_heads % M == 0 else G)), ("vocab_size", cfg.vocab_size)]
    if cfg.attn_flat and cfg.num_kv_heads % M and cfg.num_heads % M == 0 and G % (cfg.num_heads // M):
        raise NotImplementedError(f"{cfg.name} on a model axis of {M}: a rank's {cfg.num_heads // M} q heads read "
                                  f"parts of two of the {cfg.num_kv_heads} whole kv heads ({G} q heads each)")
    if cfg.moe is not None:
        dims.append(("num_experts", cfg.moe.num_experts))
    if any(not cfg.is_moe_layer(pos) for pos in range(cfg.layer_group)) and cfg.d_ff:
        dims.append(("d_ff", cfg.d_ff))
    for name, n in dims:
        if n % M:
            raise NotImplementedError(
                f"{cfg.name} on a model axis of {M}: {name}={n} does not split over it, and the port's tensor-parallel "
                f"blocks have no replicated fallback ({cfg.num_heads} q heads, {cfg.num_kv_heads} kv heads); pick a "
                "model axis that divides it")


@dataclass(frozen=True)
class ExecutionPlan:
    strategy: stg.Strategy = stg.Strategy.SINGLE
    mesh: Optional[Any] = None  # a launch.mesh.ProcessGrid
    micro_batches: int = 1
    overlap: bool = False
    use_pipeline: bool = False
    model_axis: str = "model"
    stage_kernel: str = "cuda"
    # the PipelineSchedule kind driving the pipelined backward: "gpipe"
    # recomputes all k microbatches in one group, "1f1b" and "zerobubble" one
    # at a time, "interleaved" is gpipe's table at virtual_stages=1; the same
    # gradients for all
    schedule: str = "gpipe"
    virtual_stages: int = 1
    compute_dtype: Optional[str] = None
    loss_scale_init: float = 2.0**15
    loss_scale_growth: int = 2000
    # overlapped grad sync: when set, ALL grads are partitioned into
    # ~bucket_bytes fp32 buckets, each all-reduced one microbatch late
    # (generalizes the delayed head all-reduce); None keeps the head-only delay
    bucket_bytes: Optional[int] = None

    def __post_init__(self):
        from repro_torch.core.schedule import SCHEDULES

        object.__setattr__(self, "strategy", stg.Strategy(self.strategy))
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches must be >= 1, got {self.micro_batches}")
        if self.stage_kernel not in STAGE_KERNELS:
            raise ValueError(f"stage_kernel must be one of {STAGE_KERNELS}, got {self.stage_kernel!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {self.schedule!r}")
        if self.virtual_stages < 1:
            raise ValueError(f"virtual_stages must be >= 1, got {self.virtual_stages}")
        if self.virtual_stages > 1 and self.schedule != "interleaved":
            raise ValueError(
                f"virtual_stages={self.virtual_stages} requires schedule='interleaved', "
                f"got {self.schedule!r}"
            )
        if self.compute_dtype is not None and self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}, got {self.compute_dtype!r}"
            )
        if not self.loss_scale_init > 0:
            raise ValueError(f"loss_scale_init must be > 0, got {self.loss_scale_init}")
        if self.loss_scale_growth < 1:
            raise ValueError(f"loss_scale_growth must be >= 1, got {self.loss_scale_growth}")
        if self.bucket_bytes is not None:
            if self.bucket_bytes < 1:
                raise ValueError(f"bucket_bytes must be >= 1, got {self.bucket_bytes}")
            if not self.overlap:
                # buckets only change WHEN each grad's all-reduce runs; with
                # no delayed fold they would do nothing
                raise ValueError(
                    f"bucket_bytes={self.bucket_bytes} requires overlap=True, "
                    f"got overlap={self.overlap}"
                )
        if self.overlap and self.pipelined:
            # the pipelined schedule runs ONE fwd/bwd (head grads sync once),
            # so there is no per-microbatch sync to delay
            raise ValueError(
                f"overlap={self.overlap} with use_pipeline={self.use_pipeline}: overlap "
                "applies to the accumulation schedule; a pipelined plan interleaves "
                "its microbatches inside one wavefront fwd/bwd"
            )
        if self.mesh is not None and self.model_axis not in self.mesh.axis_names:
            raise ValueError(f"model_axis={self.model_axis!r} is not an axis of the grid {self.mesh.axis_names}")

    # -- derived structure --------------------------------------------------

    @property
    def pipelined(self) -> bool:
        """Whether the wavefront pipeline backbone is active."""
        return (
            self.use_pipeline
            and self.mesh is not None
            and self.strategy in (stg.Strategy.MODEL, stg.Strategy.HYBRID)
        )

    @property
    def tensor_parallel(self) -> bool:
        """Whether the plan is a tensor-parallel layout: MODEL or HYBRID on a
        ``model`` axis above 1 without the pipeline, or HYBRID_OPT on any
        grid.  Its ranks store the blocks :meth:`placement` gives them."""
        S = stg.Strategy
        if self.mesh is None or self.pipelined:
            return False
        return self.strategy == S.HYBRID_OPT or (
            self.strategy in (S.MODEL, S.HYBRID) and self.mesh.size(self.model_axis) > 1)

    def for_config(self, cfg) -> "ExecutionPlan":
        """The plan that runs model config ``cfg``: this one, but under input
        feeding a pipelined MODEL or HYBRID plan on a ``model`` axis above 1
        becomes its tensor-parallel twin (no pipeline, one microbatch: the
        same :attr:`accum_steps` of 1).  The input-feeding decoder runs the
        head inside its recurrence, so it has no backbone to pipeline: the
        JAX package drops the backbone (``repro/train/trainer.py:109``) and
        places the parameters by the strategy alone.  An LM has no backbone
        to pipeline either (``repro/train/trainer.py:118-146``): a pipelined
        plan runs it so too, in one forward and backward.  Every method that
        takes ``cfg`` runs on the plan this returns."""
        lm = cfg.family != "seq2seq"
        if self.pipelined and (lm or cfg.input_feeding and self.mesh.size(self.model_axis) > 1):
            return dataclasses.replace(self, use_pipeline=False, micro_batches=1, schedule="gpipe", virtual_stages=1)
        return self

    @property
    def num_stages(self) -> int:
        if not self.pipelined:
            return 1
        return self.mesh.size(self.model_axis)

    @property
    def accum_steps(self) -> int:
        """Microbatches handled by the trainer's accumulation loop.  When the
        backbone is pipelined the microbatches interleave inside the
        wavefront instead (one fwd/bwd), so the trainer must not also loop."""
        return 1 if self.pipelined else self.micro_batches

    def wavefront(self, seq_len: int) -> WavefrontSchedule:
        """Forward clock arithmetic, from the full schedule's wavefront view."""
        return self.pipeline_schedule(seq_len).wavefront

    def pipeline_schedule(self, seq_len: int):
        """The full (forward + backward) :class:`PipelineSchedule` this plan
        prescribes for one wavefront of ``seq_len`` timesteps."""
        from repro_torch.core.schedule import PipelineSchedule

        return PipelineSchedule(
            seq_len=seq_len,
            num_stages=self.num_stages,
            micro_batches=self.micro_batches if self.pipelined else 1,
            kind=self.schedule,
            chunks=self.virtual_stages if self.schedule == "interleaved" else 1,
        )

    # -- mixed precision ----------------------------------------------------

    def resolve_compute_dtype(self, cfg=None) -> str:
        """The dtype the loss fn computes in: the plan's ``compute_dtype``
        when set, else the model config's ``dtype`` (fp32 when neither)."""
        if self.compute_dtype is not None:
            return self.compute_dtype
        return getattr(cfg, "dtype", "float32") if cfg is not None else "float32"

    def fp16(self, cfg=None) -> bool:
        """Whether this plan trains in float16, the one compute dtype that
        needs dynamic loss scaling (bf16 shares fp32's exponent range)."""
        return self.resolve_compute_dtype(cfg) == "float16"

    # -- batch layout -------------------------------------------------------

    def batch_axes(self) -> tuple:
        return stg.batch_axes(self.strategy, self.mesh)

    def batch_shard_size(self) -> int:
        """Product of grid axis sizes the batch dim is sharded over."""
        return stg.batch_shard_size(self.strategy, self.mesh)

    def validate_batch(self, global_batch: int) -> None:
        if global_batch % self.micro_batches:
            raise ValueError(
                f"global batch {global_batch} not divisible by micro_batches={self.micro_batches}"
            )
        dsz = self.batch_shard_size()
        if global_batch % dsz:
            raise ValueError(
                f"global batch {global_batch} not divisible by the {dsz} batch "
                f"shards of strategy={self.strategy.value} on this grid "
                "(batch-sharded executors refuse to run unsharded); pad the "
                "global batch or pick a grid whose batch axes divide it"
            )
        if global_batch % (dsz * self.micro_batches):
            raise ValueError(
                f"global batch {global_batch} not divisible by batch shards x "
                f"micro_batches = {dsz} x {self.micro_batches}"
            )
        if self.strategy == stg.Strategy.HYBRID and self.mesh is not None and global_batch % self.mesh.world:
            raise ValueError(
                f"global batch {global_batch} not divisible by the {self.mesh.world} ranks the hybrid "
                "phase boundary spreads the head's rows over"
            )
        if (self.strategy == stg.Strategy.HYBRID and self.mesh is not None
                and global_batch % (self.mesh.world * self.accum_steps)):
            raise ValueError(
                f"global batch {global_batch} not divisible by the {self.mesh.world} ranks x {self.accum_steps} "
                "accumulated microbatches: each microbatch's head rows spread over every rank"
            )

    def split_micro(self, batch: dict) -> list:
        """{name: [B, ...]} -> ``accum_steps`` dicts of [B/k, ...] slices of
        the global batch (views; row order kept)."""
        k = self.accum_steps
        self.validate_batch(next(iter(batch.values())).shape[0])
        parts = {name: v.chunk(k, dim=0) for name, v in batch.items()}
        return [{name: parts[name][i] for name in batch} for i in range(k)]

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a (micro)batch for the backbone: its block of
        ``batch_shard_size`` equal row blocks (views)."""
        n = self.batch_shard_size()
        if n == 1:
            return batch
        i = stg.batch_shard_index(self.strategy, self.mesh)
        return {name: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for name, v in batch.items()}

    def shard_rows(self, local: int) -> Optional[tuple]:
        """(lo, full): where this rank's ``local`` backbone rows sit in the
        (micro)batch, for the dropout masks; None when the batch is not
        sharded."""
        n = self.batch_shard_size()
        if n == 1:
            return None
        return (stg.batch_shard_index(self.strategy, self.mesh) * local, n * local)

    def loss_axis(self) -> Optional[str]:
        """The grid axis the head's rows, and so the loss's token count, are
        spread over (None: every rank sees all of them).  MODEL and
        HYBRID_OPT on the tensor-parallel backbone run the head on the data
        shard's rows on every ``model`` rank: over ``data``."""
        if self.mesh is None or self.strategy == stg.Strategy.SINGLE or self.mesh.world == 1:
            return None
        if self.tensor_parallel and self.strategy != stg.Strategy.HYBRID:
            return "data" if self.mesh.size("data") > 1 else None
        return "all"

    def phase_boundary(self) -> Callable:
        return stg.phase_boundary_fn(self.strategy, self.mesh, tensor_parallel=self.tensor_parallel)

    # -- backbone selection -------------------------------------------------

    @_for_config
    def backbone(self, cfg) -> Optional[Callable]:
        """The stacked-LSTM executor this plan prescribes for the seq2seq
        backbone (None: the plain layer loop on every row)."""
        from repro_torch.core import pipeline as pl  # local: avoid an import cycle

        if self.tensor_parallel:
            M = self.mesh.size(self.model_axis)
            for name, n in (("d_model", cfg.d_model), ("vocab_size", cfg.vocab_size)):
                if n % M:
                    raise ValueError(f"the tensor-parallel layouts split {name}={n} over the model axis of {M}; "
                                     "pick a model axis that divides it")
            return pl.tensor_parallel_backbone(self.mesh, model_axis=self.model_axis, dropout=cfg.dropout,
                                               stage_kernel=self.stage_kernel)
        if self.pipelined:
            return pl.pipeline_backbone(
                self.mesh,
                model_axis=self.model_axis,
                micro_batches=self.micro_batches,
                stage_kernel=self.stage_kernel,
                schedule=self.schedule,
                virtual_stages=self.virtual_stages,
                dropout=cfg.dropout,
            )
        if self.mesh is not None and self.batch_shard_size() > 1:
            return pl.batch_shard_backbone(self.mesh, self.batch_axes(), dropout=cfg.dropout,
                                           stage_kernel=self.stage_kernel)
        return None

    # -- parameter placement ------------------------------------------------

    @_for_config
    def placement(self, cfg) -> dict:
        """The placement tree of ``cfg``'s parameters: for each leaf, per
        dim, the grid axis that shards it or None.  The JAX rule
        (``stg.param_placement``) on the tensor-parallel layouts; nothing
        sharded on the others.  An LM's by the same rule on its spec tree
        (``models/transformer.py::param_specs``), on the plans
        :func:`check_lm_plan` takes."""
        from repro_torch.models import seq2seq as s2s  # local: avoid an import cycle
        from repro_torch.models import transformer as tfm

        if cfg.family != "seq2seq":
            check_lm_plan(self, cfg)
            shapes, specs = tfm.param_shapes(cfg), tfm.param_specs(cfg)
        else:
            shapes, specs = s2s.param_shapes(cfg), s2s.param_specs(cfg.num_layers)
        if not self.tensor_parallel:
            return stg.map_shapes(lambda shape: (None,) * len(shape), shapes)
        return stg.param_placement(specs, shapes, self.mesh, self.strategy)

    @_for_config
    def sharding(self, cfg) -> Optional[stg.Sharding]:
        """The collectives of ``cfg``'s placement, for the model's forward
        (None unless the plan runs ``cfg`` tensor-parallel)."""
        if not self.tensor_parallel:
            return None
        return stg.Sharding(self.mesh, self.placement(cfg), self.model_axis)

    @_for_config
    def shard_params(self, params, cfg):
        """This rank's blocks of ``cfg``'s whole tree ``params``
        (``strategy.shard_params``)."""
        return stg.shard_params(params, self.placement(cfg), self.mesh)

    # -- parameter ownership and grad sync ---------------------------------

    @_for_config
    def leaf_roles(self, params, cfg) -> list:
        """One :class:`LeafRole` per leaf, in ``tree_leaves`` order.

        * no grid, SINGLE: every rank computes every grad whole;
        * DATA: every grad summed over the grid;
        * MODEL/HYBRID pipelined or batch-sharded: stage 0 owns the
          embeddings and each layer's stage (``pipeline.layer_stage``: stage
          s layers [s*Lp, (s+1)*Lp), or its virtual stages' chunks on the
          ring) owns it, each grad summed over ``data``; the head is
          replicated and summed over the grid (HYBRID), or owned by the top
          stage and summed over ``data`` (MODEL);
        * tensor-parallel: each leaf sharded as :meth:`placement` says, its
          grad summed over the axes that do not shard it (``grad_axes``);
        * an LM on a grid: every rank computes every grad, summed as on the
          tensor-parallel layouts, but for the leaves whose grad each
          ``model`` rank computes whole (``transformer.grad_whole_on_model``:
          the norms), summed over ``data`` alone."""
        from repro_torch.core.pipeline import layer_stage  # local: avoid an import cycle
        from repro_torch.models.transformer import grad_whole_on_model

        S = stg.Strategy
        placed = _placed_leaves(params, self.placement(cfg))
        out = []
        for (path, _), p in zip(_paths(params), placed):
            if self.mesh is None or self.strategy == S.SINGLE:
                out.append(LeafRole(None, None))
            elif self.strategy == S.DATA:
                out.append(LeafRole(None, "all"))
            elif cfg.family != "seq2seq":
                axes = stg.grad_axes(p, self.mesh)
                if self.tensor_parallel and grad_whole_on_model(path):
                    axes = tuple(a for a in axes if a != self.model_axis)
                out.append(LeafRole(None, stg.axis_name(axes), stg.leaf_axes(p)))
            elif self.tensor_parallel:
                out.append(LeafRole(None, stg.axis_name(stg.grad_axes(p, self.mesh)), stg.leaf_axes(p)))
            elif path[0] in stg.HEAD_KEYS:
                M = self.mesh.size(self.model_axis)
                out.append(LeafRole(None, "all") if self.strategy == S.HYBRID else LeafRole(M - 1, "data"))
            elif path[0] in ("encoder", "decoder"):
                L, M = len(params[path[0]]), self.mesh.size(self.model_axis)
                v = self.virtual_stages if self.pipelined else 1
                out.append(LeafRole(layer_stage(path[1], L, M, v), "data"))
            else:  # embeddings
                out.append(LeafRole(0, "data"))
        return out

    @_for_config
    def gather_params(self, params, cfg):
        """The whole tree from this rank's part of ``cfg``'s params: every
        sharded leaf all-gathered along its sharded dims, every owned leaf
        broadcast over the ``model`` axis from its stage; what a checkpoint
        writes and the tests compare.  Every rank must call it."""
        leaves = [t.detach().clone() for t in tree_leaves(params)]
        if self.mesh is not None and self.tensor_parallel:
            placed = _placed_leaves(params, self.placement(cfg))
            leaves = [stg.gather_leaf(t, p, self.mesh) for t, p in zip(leaves, placed)]
        elif self.mesh is not None and self.mesh.size(self.model_axis) > 1:
            for leaf, role in zip(leaves, self.leaf_roles(params, cfg)):
                if role.owner is not None:
                    self.mesh.broadcast(leaf, self.model_axis, role.owner)
        it = iter(leaves)
        return tree_map(lambda _: next(it), params)

    # -- head/backbone split (overlapped grad sync) -------------------------

    @staticmethod
    def split_head(tree: dict) -> tuple[dict, dict]:
        """Partition a top-level param/grad dict into (head, backbone) per
        ``strategy.HEAD_KEYS``: the paper's data-parallel attention-softmax
        part vs the model-parallel backbone."""
        head = {k: v for k, v in tree.items() if k in stg.HEAD_KEYS}
        body = {k: v for k, v in tree.items() if k not in stg.HEAD_KEYS}
        return head, body

    @staticmethod
    def merge_head(head: dict, body: dict) -> dict:
        return {**head, **body}

    def grad_buckets(self, tree: Any) -> list[dict]:
        """Partition the grad tree's leaves into size-targeted buckets for
        the delayed (one-microbatch-late) all-reduce.

        Greedy over JAX's flatten order (dict keys sorted), so the buckets
        are the JAX plan's: a leaf joins the current bucket until it holds >=
        ``bucket_bytes`` of fp32 grads.  Returns ``[{"index": i, "leaves":
        [positions in tree_leaves order], "bytes": fp32 bytes, "names": [dot
        paths]}]`` covering every leaf exactly once."""
        if self.bucket_bytes is None:
            raise ValueError("grad_buckets requires bucket_bytes to be set, got bucket_bytes=None")
        position = {path: i for i, (path, _) in enumerate(_paths(tree))}
        buckets: list[dict] = []
        cur = {"index": 0, "leaves": [], "bytes": 0, "names": []}
        for path, leaf in _paths(tree, sort=True):
            cur["leaves"].append(position[path])
            cur["bytes"] += 4 * math.prod(leaf.shape)
            cur["names"].append(".".join(str(p) for p in path))
            if cur["bytes"] >= self.bucket_bytes:
                buckets.append(cur)
                cur = {"index": len(buckets), "leaves": [], "bytes": 0, "names": []}
        if cur["leaves"]:
            buckets.append(cur)
        return buckets


@dataclass(frozen=True)
class ServePlan:
    cache_policy: str = "encdec_memory"
    max_slots: int = 8
    max_len: int = 512  # per-slot source capacity
    prefill_chunk: int = 32
    admission: str = "continuous"
    window: Optional[int] = None  # rolling buffer size (cache_policy="window")
    stage_kernel: str = "cuda"

    def __post_init__(self):
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(f"cache_policy={self.cache_policy!r} is not ported yet; ported: {CACHE_POLICIES}")
        if self.admission not in ADMISSIONS:
            raise ValueError(f"admission must be one of {ADMISSIONS}, got {self.admission!r}")
        if self.stage_kernel not in STAGE_KERNELS:
            raise ValueError(f"stage_kernel must be one of {STAGE_KERNELS}, got {self.stage_kernel!r}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1 or self.prefill_chunk < 1:
            raise ValueError(f"max_len/prefill_chunk must be >= 1, got {self.max_len}/{self.prefill_chunk}")
        if self.max_len % self.prefill_chunk:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must divide max_len={self.max_len} "
                "(chunked prefill tiles the cache capacity exactly)"
            )
        if self.cache_policy == "window":
            if self.window is None or self.window < 1:
                raise ValueError(f"cache_policy='window' requires a positive window, got window={self.window!r}")
            if self.prefill_chunk > self.window:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} cannot exceed window={self.window} "
                    "(a chunk must not wrap the rolling buffer onto itself)"
                )
        elif self.window is not None:
            raise ValueError(f"window is only meaningful for cache_policy='window', got {self.cache_policy!r}")

    @classmethod
    def for_config(cls, cfg, **overrides) -> "ServePlan":
        """Default plan for an architecture: seq2seq -> encdec_memory, a
        sliding window -> window (of ``cfg.sliding_window`` slots), else
        full_kv.  Unlike the strict constructor, a requested
        ``prefill_chunk`` is fitted to the largest divisor of ``max_len``
        that does not exceed it (nor the window)."""
        unported = sorted(NOT_PORTED & set(overrides))
        if unported:
            raise NotImplementedError(f"ServePlan fields {unported} are not ported yet")
        if cfg.family not in ("seq2seq", "dense", "moe"):
            raise NotImplementedError(f"serving the {cfg.family!r} family is not ported yet")
        if "cache_policy" not in overrides:
            if cfg.family == "seq2seq":
                overrides["cache_policy"] = "encdec_memory"
            elif cfg.sliding_window:
                overrides["cache_policy"] = "window"
                overrides.setdefault("window", cfg.sliding_window)
            else:
                overrides["cache_policy"] = "full_kv"
        want = overrides.get("prefill_chunk", cls.prefill_chunk)
        if overrides["cache_policy"] == "window" and overrides.get("window"):
            want = min(want, overrides["window"])  # a chunk must not wrap the buffer
        overrides["prefill_chunk"] = fit_block(overrides.get("max_len", cls.max_len), want)
        plan = cls(**overrides)
        plan.validate_for(cfg)
        return plan

    def validate_for(self, cfg) -> None:
        """The policy names the per-slot state, so it must match the family."""
        is_s2s = cfg.family == "seq2seq"
        if self.cache_policy == "encdec_memory" and not is_s2s:
            raise ValueError(f"encdec_memory serves the seq2seq family, not {cfg.family!r}")
        if is_s2s and self.cache_policy != "encdec_memory":
            raise ValueError(f"the seq2seq family requires cache_policy='encdec_memory', got {self.cache_policy!r}")

    def validate_batch(self, num_requests: int) -> None:
        """Static admission runs one batch start to finish: it must fit the
        slot table.  Continuous admission queues any overflow."""
        if self.admission == "static" and num_requests > self.max_slots:
            raise ValueError(
                f"static admission: {num_requests} requests exceed max_slots={self.max_slots} "
                "(use admission='continuous' to queue)"
            )
