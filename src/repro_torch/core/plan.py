"""The port's execution plans: the meshless training half of
``repro.core.plan.ExecutionPlan``, and the subset of
``repro.core.plan.ServePlan`` that serves the seq2seq family under the
``encdec_memory`` cache policy and the dense and MoE LM families under
``full_kv`` and ``window``.

:class:`ExecutionPlan` (training on one card):

* ``micro_batches``: the global batch splits into this many microbatches,
  whose grads the trainer accumulates in fp32 (``accum_steps``);
* ``stage_kernel``: ``cuda`` (the fused LSTM cell and Luong head kernels)
  or ``torch`` (the plain math);
* ``compute_dtype``: the activations' dtype (None: the config's); the
  weights, optimizer moments and grad sums stay fp32;
* ``loss_scale_init`` / ``loss_scale_growth``: fp16's dynamic loss scale.

The JAX plan's multi-device fields (strategy, mesh, overlap, pipeline,
schedule, bucket size) are not ported: the hybrid layout is ROADMAP
queue 4, and the constructor rejects them as unknown keywords.

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

The ``recurrent`` policy and the paged, mesh and speculative fields of the
JAX plan are not ported: :meth:`ServePlan.for_config` raises on them by
name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.kernels import fit_block

CACHE_POLICIES = ("full_kv", "window", "encdec_memory")
ADMISSIONS = ("static", "continuous")
STAGE_KERNELS = ("torch", "cuda")
NOT_PORTED = frozenset({
    "strategy", "mesh", "page_size", "num_pages", "share_prefixes",
    "draft_arch", "draft_len", "acceptance",
})


# training compute precisions; params, optimizer moments and grad sums stay fp32
COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


@dataclass(frozen=True)
class ExecutionPlan:
    micro_batches: int = 1
    stage_kernel: str = "cuda"
    compute_dtype: Optional[str] = None
    loss_scale_init: float = 2.0**15
    loss_scale_growth: int = 2000

    def __post_init__(self):
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches must be >= 1, got {self.micro_batches}")
        if self.stage_kernel not in STAGE_KERNELS:
            raise ValueError(f"stage_kernel must be one of {STAGE_KERNELS}, got {self.stage_kernel!r}")
        if self.compute_dtype is not None and self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {self.compute_dtype!r}")
        if not self.loss_scale_init > 0:
            raise ValueError(f"loss_scale_init must be > 0, got {self.loss_scale_init}")
        if self.loss_scale_growth < 1:
            raise ValueError(f"loss_scale_growth must be >= 1, got {self.loss_scale_growth}")

    @property
    def accum_steps(self) -> int:
        """Microbatches the trainer accumulates over (no pipeline here)."""
        return self.micro_batches

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

    def validate_batch(self, global_batch: int) -> None:
        if global_batch % self.micro_batches:
            raise ValueError(f"global batch {global_batch} not divisible by micro_batches={self.micro_batches}")

    def split_micro(self, batch: dict) -> list:
        """{name: [B, ...]} -> ``accum_steps`` dicts of [B/k, ...] slices
        (views; row order kept)."""
        k = self.accum_steps
        self.validate_batch(next(iter(batch.values())).shape[0])
        parts = {name: v.chunk(k, dim=0) for name, v in batch.items()}
        return [{name: parts[name][i] for name in batch} for i in range(k)]


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
