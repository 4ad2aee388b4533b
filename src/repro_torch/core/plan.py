"""ServePlan: the subset of ``repro.core.plan.ServePlan`` that serves the
seq2seq family under the ``encdec_memory`` cache policy.

* ``cache_policy`` is ``encdec_memory``: the encoder states S are the
  cached memory; decode is one decoder-LSTM step plus the Luong head.
* ``max_slots`` is the slot-table size; the decode tick runs all slots and
  masks the inactive ones.
* ``max_len`` is each slot's source capacity.
* ``prefill_chunk``: a source enters ``prefill_chunk`` tokens per step
  while that many remain, then one token per step.
* ``admission``: ``static`` admits one batch up front; ``continuous``
  admits from the queue whenever a slot frees.
* ``stage_kernel``: what computes the Luong head, ``cuda`` (the
  hand-written kernel) or ``torch`` (the plain math).

The paged, mesh, speculative and LM fields of the JAX plan are not ported:
:meth:`ServePlan.for_config` raises on them by name.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels import fit_block

CACHE_POLICIES = ("encdec_memory",)
ADMISSIONS = ("static", "continuous")
STAGE_KERNELS = ("torch", "cuda")
NOT_PORTED = frozenset({
    "strategy", "mesh", "window", "page_size", "num_pages", "share_prefixes",
    "draft_arch", "draft_len", "acceptance",
})


@dataclass(frozen=True)
class ServePlan:
    cache_policy: str = "encdec_memory"
    max_slots: int = 8
    max_len: int = 512  # per-slot source capacity
    prefill_chunk: int = 32
    admission: str = "continuous"
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

    @classmethod
    def for_config(cls, cfg, **overrides) -> "ServePlan":
        """Default plan for an architecture.  Unlike the strict constructor,
        a requested ``prefill_chunk`` is fitted to the largest divisor of
        ``max_len`` that does not exceed it."""
        unported = sorted(NOT_PORTED & set(overrides))
        if unported:
            raise NotImplementedError(f"ServePlan fields {unported} are not ported yet")
        if cfg.family != "seq2seq":
            raise NotImplementedError(f"serving the {cfg.family!r} family is not ported yet")
        overrides.setdefault("cache_policy", "encdec_memory")
        want = overrides.get("prefill_chunk", cls.prefill_chunk)
        overrides["prefill_chunk"] = fit_block(overrides.get("max_len", cls.max_len), want)
        plan = cls(**overrides)
        plan.validate_for(cfg)
        return plan

    def validate_for(self, cfg) -> None:
        """The policy names the per-slot state, so it must match the family."""
        if cfg.family != "seq2seq":
            raise ValueError(f"encdec_memory serves the seq2seq family, not {cfg.family!r}")

    def validate_batch(self, num_requests: int) -> None:
        """Static admission runs one batch start to finish: it must fit the
        slot table.  Continuous admission queues any overflow."""
        if self.admission == "static" and num_requests > self.max_slots:
            raise ValueError(
                f"static admission: {num_requests} requests exceed max_slots={self.max_slots} "
                "(use admission='continuous' to queue)"
            )
