"""The port's execution plans: ``repro.core.plan.ExecutionPlan`` for
training, and the subset of ``repro.core.plan.ServePlan`` that serves the
seq2seq family under the ``encdec_memory`` cache policy and the dense and
MoE LM families under ``full_kv`` and ``window``.

:class:`ExecutionPlan` binds once how a training step executes:

    (strategy, process grid, pipeline stages, microbatches, overlap flags)

* ``strategy`` and ``mesh``: SINGLE/DATA/MODEL/HYBRID (``core/strategy.py``)
  on a :class:`~repro_torch.launch.mesh.ProcessGrid` of ``data x model``
  ranks, or None for one process;
* ``use_pipeline`` (with MODEL or HYBRID on a grid): the stacked LSTMs run
  as the wavefront pipeline over the ``model`` ranks (``core/pipeline.py``),
  the k microbatches *interleaved inside one wavefront*, so the
  (NS-1)-tick fill/drain is paid once per step and the trainer does not
  also accumulate (``accum_steps == 1``); ``schedule`` (gpipe, 1f1b,
  zerobubble, interleaved) drives its backward;
* otherwise ``micro_batches`` is the classic gradient accumulation, and
  ``overlap`` delays the all-reduce of each microbatch's head grads (with
  ``bucket_bytes``: of every grad, in size-targeted buckets) by one
  microbatch, so it runs under the next microbatch's compute;
* ``stage_kernel``: ``cuda`` (the fused LSTM cell and Luong head kernels)
  or ``torch`` (the plain math);
* ``compute_dtype``: the activations' dtype (None: the config's); the
  weights, optimizer moments and grad sums stay fp32;
* ``loss_scale_init`` / ``loss_scale_growth``: fp16's dynamic loss scale.

Every validator of the JAX plan is kept.  Two layouts the JAX package has
are not ported and raise by name (ROADMAP queue 1 item 4):
``virtual_stages > 1`` (the interleaved ring executor) and MODEL or HYBRID on
a ``model`` axis above 1 without the pipeline (the tensor-parallel
backbone); so is ``strategy="hybrid_opt"`` on a grid.

Each rank holds the whole parameter tree; :meth:`ExecutionPlan.leaf_roles`
says which leaves it owns (a pipeline stage its layers, stage 0 the
embeddings) and over which axis each leaf's grad is summed.

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
NOT_PORTED_LAYOUT = "ROADMAP queue 1 item 4"


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
    the ``model`` coordinate that computes it (None: every rank does), and
    ``axis`` the grid axis its grad is summed over (None: no sum)."""

    owner: Optional[int]
    axis: Optional[str]


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
        # the JAX layouts the port does not have yet
        if self.mesh is not None and self.model_axis not in self.mesh.axis_names:
            raise ValueError(f"model_axis={self.model_axis!r} is not an axis of the grid {self.mesh.axis_names}")
        if self.virtual_stages > 1:
            raise NotImplementedError(
                f"virtual_stages={self.virtual_stages}: the interleaved ring executor is not ported "
                f"({NOT_PORTED_LAYOUT}); schedule='interleaved' runs at virtual_stages=1")
        if self.strategy == stg.Strategy.HYBRID_OPT and self.mesh is not None:
            raise NotImplementedError(stg.HYBRID_OPT_NOT_PORTED)
        if (self.mesh is not None and self.strategy in (stg.Strategy.MODEL, stg.Strategy.HYBRID)
                and self.mesh.size(self.model_axis) > 1 and not self.use_pipeline):
            raise NotImplementedError(
                f"strategy={self.strategy.value} on a model axis of {self.mesh.size(self.model_axis)} without "
                f"use_pipeline: the tensor-parallel backbone is not ported ({NOT_PORTED_LAYOUT}); "
                "pass use_pipeline=True for the wavefront pipeline")

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
        spread over (None: every rank sees all of them)."""
        if self.mesh is None or self.strategy == stg.Strategy.SINGLE or self.mesh.world == 1:
            return None
        return "all"

    def phase_boundary(self) -> Callable:
        return stg.phase_boundary_fn(self.strategy, self.mesh)

    # -- backbone selection -------------------------------------------------

    def backbone(self, cfg) -> Optional[Callable]:
        """The stacked-LSTM executor this plan prescribes for the seq2seq
        backbone (None: the plain layer loop on every row)."""
        from repro_torch.core import pipeline as pl  # local: avoid an import cycle

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

    # -- parameter ownership and grad sync ---------------------------------

    def leaf_roles(self, params) -> list:
        """One :class:`LeafRole` per leaf, in ``tree_leaves`` order.

        * no grid, SINGLE: every rank computes every grad whole;
        * DATA: every grad summed over the grid;
        * MODEL/HYBRID: stage 0 owns the embeddings and stage s layers
          [s*Lp, (s+1)*Lp) of the encoder and the decoder, each grad summed
          over ``data``; the head is replicated and summed over the grid
          (HYBRID), or owned by the top stage and summed over ``data``
          (MODEL)."""
        S = stg.Strategy
        out = []
        for path, _ in _paths(params):
            if self.mesh is None or self.strategy == S.SINGLE:
                out.append(LeafRole(None, None))
            elif self.strategy == S.DATA:
                out.append(LeafRole(None, "all"))
            elif path[0] in stg.HEAD_KEYS:
                M = self.mesh.size(self.model_axis)
                out.append(LeafRole(None, "all") if self.strategy == S.HYBRID else LeafRole(M - 1, "data"))
            elif path[0] in ("encoder", "decoder"):
                L, M = len(params[path[0]]), self.mesh.size(self.model_axis)
                if L % M:
                    raise ValueError(f"{L} {path[0]} layers cannot split into {M} stages")
                out.append(LeafRole(path[1] // (L // M), "data"))
            else:  # embeddings
                out.append(LeafRole(0, "data"))
        return out

    def gather_params(self, params):
        """A copy of ``params`` in which every leaf holds its owner's value
        (each owned leaf broadcast over the ``model`` axis from its stage):
        what a checkpoint writes.  Every rank must call it."""
        leaves = [t.detach().clone() for t in tree_leaves(params)]
        if self.mesh is not None and self.mesh.size(self.model_axis) > 1:
            for leaf, role in zip(leaves, self.leaf_roles(params)):
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
